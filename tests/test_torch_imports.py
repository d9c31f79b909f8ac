"""The port stands alone: importing every module of scx_torch, and
chip_smoke.py, loads neither JAX nor the JAX package.

Each is imported in a fresh interpreter (this test process has both
loaded), and sys.modules is checked afterwards."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import scx_torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "scx", "flax"))
print(",".join(bad))
"""


def test_port_imports_neither_jax_nor_scx():
    mods = ["scx_torch"] + [m.name for m in pkgutil.walk_packages(scx_torch.__path__,
                                                                   "scx_torch.")]
    assert "scx_torch.app.rlenv" in mods and len(mods) > 30
    for new in ("scx_torch.rl.gae", "scx_torch.rl.ppo", "scx_torch.rl.gymenv",
                "scx_torch.rl.train_ppo", "scx_torch.core.tree", "scx_torch.parallel",
                "scx_torch.parallel.mesh",
                "scx_torch.parallel.spatial", "scx_torch.parallel.bigscene",
                "scx_torch.parallel.streamed_bigscene", "scx_torch.parallel.dryrun",
                "scx_torch.app.debugui", "scx_torch.tools", "scx_torch.tools.asset_db",
                "scx_torch.tools.editor", "scx_torch.tools.editor_app",
                "scx_torch.physics.boxbox", "scx_torch.physics.warmstart",
                "scx_torch.profile_spatial"):
        assert new in mods, new
    out = subprocess.run([sys.executable, "-c", _PROBE, *mods, "chip_smoke"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"
