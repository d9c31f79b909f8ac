"""The plain reference of the pile (reference/pile64.py) against the port on
the CPU at a tiny size: it shares no code with the program, works out the
same constants from the raw scenes, and follows the program's fused and
staged steps through a drop within the cell's limits."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import compare
from portbench.configs import pile64 as pile_cfg
from portbench.reference import pile64 as ref
from portbench.run import read_json

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
CFG = read_json("portbench/configs/pile64.json")


def tensors(obj) -> list:
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out += list(v) if isinstance(v, tuple) else [v]
    return out


def test_pile_scenes_are_bench_scenes_at_bench_seed():
    from scx_torch.physics import fleet

    ours = pile_cfg.program_bodies(CFG, *pile_cfg.scenes(CFG, 3, 1337, CPU))
    theirs = fleet.build_pile_fleet(3, 64, CPU)
    assert all(torch.equal(a, b) for a, b in zip(tensors(ours), tensors(theirs)))
    other = pile_cfg.scenes(CFG, 3, 2**31 + 11, CPU)[0]
    assert not torch.equal(other, pile_cfg.scenes(CFG, 3, 1337, CPU)[0])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.pile64\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'scx_torch', 'scx', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_reference_constants_are_the_programs():
    pos, size, dynamic = pile_cfg.scenes(CFG, 2, 7, CPU)
    st = ref.statics(CFG, size, dynamic)
    got = ref.program_statics(pile_cfg.program_bodies(CFG, pos, size, dynamic))
    assert ref.static_err(got, st) < 1e-6
    got["friction"] = got["friction"] * 1.01
    assert ref.static_err(got, st) > 1e-3


@pytest.mark.parametrize("route", ["fused", "staged"])
def test_reference_follows_the_port_through_a_drop(route):
    from scx_torch.physics import planar

    port_step = {"fused": planar.step_planar_cached, "staged": planar.step_planar_staged}[route]
    limits = compare.limits(f"pile64.{'drop' if route == 'fused' else 'staged'}")
    pos, size, dynamic = pile_cfg.scenes(CFG, 4, 2**31 + 5, CPU)
    st = ref.statics(CFG, size, dynamic)
    b = pile_cfg.program_bodies(CFG, pos, size, dynamic)
    prm = pile_cfg.solver_params(CFG)
    c = planar.empty_planar_cache(4, prm.max_pairs, device=CPU)
    contacts = 0
    for k in range(60):  # into the drop: contacts appear from step ~20
        pre = ref.from_program(b, c)
        b, c, _ = port_step(b, prm, c)
        if k % 4 == 3:
            out, amb, ill = ref.step(pre, st, CFG)
            r = ref.readings(ref.from_program(b, c), out, amb, ill, dynamic)
            assert all(r[n] <= limits[n] for n in r), (k, r)
            contacts = max(contacts, int(out.valid.sum()))
    assert contacts > 0


def test_control_is_not_the_reference():
    from scx_torch.physics import planar

    pos, size, dynamic = pile_cfg.scenes(CFG, 4, 2**31 + 5, CPU)
    st = ref.statics(CFG, size, dynamic)
    b = pile_cfg.program_bodies(CFG, pos, size, dynamic)
    prm = pile_cfg.solver_params(CFG)
    c = planar.empty_planar_cache(4, prm.max_pairs, device=CPU)
    for _ in range(30):
        b, c, _ = planar.step_planar_cached(b, prm, c)
    pre = ref.from_program(b, c)
    low = ref.Statics(**{k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                         for k, v in st.__dict__.items()})
    out, amb, ill = ref.step(pre, st, CFG)
    ctl, _, _ = ref.step(pre, low, CFG, dtype=torch.bfloat16)
    r = ref.readings(ctl, out, amb, ill, dynamic)
    limits = compare.limits("pile64.drop")
    assert any(r[n] > limits[n] for n in r), r


def test_limits_files_name_their_readings():
    for cell in ("pile64.drop", "pile64.staged"):
        data = json.loads((ROOT / "portbench" / "reference" / f"{cell}.limits.json").read_text())
        assert {"off_route", "static_err", "deep_flip_envs", "flip_env_share", "vel_err",
                "pos_err", "lam_err"} == set(data["limits"])
