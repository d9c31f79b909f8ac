"""Rank shards equal local shards, bit for bit: the port's mesh over two
gloo ranks (two processes spawned here, with a timeout of their own)
against the same mesh as local shards in this process, on the same global
input (tests/torch_dist_worker.py): 30 steps of the spatial strip step
(two strips, a box that crosses), the streamed big scene's two strips
(each rank streams its own strip's sectors and writes only its [1, N]
shard; every column, the uids included, and the active sectors after
settling around two cameras), a 3-step rollout_sharded of a 4-env RL
fleet over 'dp', one REINFORCE train step of that fleet over 'dp' (the
parameters, loss and mean return every rank holds, and each rank's envs)
and the multi-host demo's rollout (8 envs a shard; its stats). The halo and migration hops are send/recv pairs there
and tensor shifts here; the sums are gathered and added in shard order in
both."""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

import torch_dist_worker as w
from scx_torch.parallel import mesh as tm

from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

WORKER = Path(__file__).with_name("torch_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_ranks_equal_local_shards(tmp_path):
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2", str(port),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        local = w.run(tm.make_mesh(dp=1, sp=2, device="cpu"))
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert local["stats"][:, 2].sum() >= 1  # "migrated": the box crossed
    for i in range(len(w.CAMERAS)):  # both strips streamed their three sectors
        assert local[f"s{i}_alive"][:, :w.STREAM_ROWS].any(1).all()
        assert local[f"s{i}_sectors"].shape == (2, 3, 2)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["stats"], local["stats"])
        for k in (k for k in local if k.startswith("b_")):
            np.testing.assert_array_equal(got[k], local[k][r:r + 1], err_msg=k)
            np.testing.assert_array_equal(got["g" + k[1:]], local[k], err_msg=k)
        np.testing.assert_array_equal(got["alive"], local["alive"])
        for k in (k for k in local if k[0] == "s" and k[1].isdigit()):
            np.testing.assert_array_equal(got[k], local[k][r:r + 1], err_msg=k)
        envs = slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(got["means"], local["means"][:, envs])
        np.testing.assert_array_equal(got["rewards"], local["rewards"][:, envs])
        np.testing.assert_array_equal(got["pos"], local["pos"][envs])
        for k in (k for k in local if k.startswith(("rl_", "pi_", "demo_")) and k != "pi_pos"):
            np.testing.assert_array_equal(got[k], local[k], err_msg=k)
        np.testing.assert_array_equal(got["pi_pos"], local["pi_pos"][envs])
    assert local["pi_loss"] != 0 and local["demo_finite"] and local["demo_alive"] > 0
    assert local["demo_nan_rollbacks"] == 0


def test_local_mesh_collectives():
    """Local shards on a 2 x 3 mesh: flat dp-major indices, one-hop shifts
    with a zero at the open end, sums in shard order, the process's part
    and the whole being the same tensor."""
    import torch

    mesh = tm.make_mesh(dp=2, sp=3, device="cpu")
    assert mesh.n_local("sp") == 3 and mesh.n_local() == 6
    assert mesh.axis_index(("dp", "sp")).tolist() == list(range(6))
    x = torch.arange(1.0, 4.0)[:, None].repeat(1, 2)  # shard k holds k + 1
    assert mesh.ppermute(x, "sp", +1)[:, 0].tolist() == [0.0, 1.0, 2.0]
    assert mesh.ppermute(x, "sp", -1)[:, 0].tolist() == [2.0, 3.0, 0.0]
    assert mesh.psum(x, "sp").tolist() == [6.0, 6.0] and mesh.pmax(x, "sp").tolist() == [3, 3]
    batch = {"a": torch.arange(8.0)}
    assert tm.shard_env_batch(batch, mesh)["a"] is not None
    assert torch.equal(tm.env_sharded(lambda b: {"a": b["a"] * 2}, mesh)(batch)["a"],
                       torch.arange(8.0) * 2)
    assert mesh.per_shard(torch.arange(4), "dp").tolist() == [[0, 1], [2, 3]]
    assert tm.psum_stats({"n": torch.tensor([1, 2])}, mesh, "dp")["n"].item() == 3


def test_dryrun_multichip_on_cpu(capsys):
    """The multi-shard dry run (scx's dryrun_multichip counterpart) on a
    dp=4 x sp=2 mesh of local shards: every scale-out path runs and prints
    scx's summary."""
    from scx_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, "cpu")
    assert out["dp"] == 4 and out["sp"] == 2 and out["images"] == [8, 32, 64, 4]
    assert out["bigscene_migrated"] > 0 and out["fleet_alive"] > 0
    assert "dryrun_multichip ok: mesh dp=4 sp=2" in capsys.readouterr().out
