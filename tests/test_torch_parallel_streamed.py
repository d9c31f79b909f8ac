"""Streaming over spatial strips (scx_torch.parallel.streamed_bigscene)
against scx's, on scx's scenario (tests/test_parallel_streamed.py:94-158:
two strips of one 64 m sector column each, 640 rows a strip of which 512
are streamed, load radius 1): each strip streams only its own sectors, and
the streamed entities (position, mesh, sector) are scx's exactly, after
loading around (64, 0, 32) and after moving four sectors north (the old
rows despawned); the host's bookkeeping matches the device rows, and no
row past the streamed region is touched. Sector activation order follows
the loader threads' timing, so rows are compared as sorted sets."""

import jax
import numpy as np
import torch

from scx.parallel.mesh import make_mesh as jmake_mesh
from scx.parallel.streamed_bigscene import StreamedBigScene as JSBS

from scx_torch.core.config import StreamingBudgets, WorldPartitionConfig
from scx_torch.parallel import mesh as tm
from scx_torch.parallel.streamed_bigscene import StreamedBigScene
from scx_torch.state import entity as ent

from tests.test_parallel_streamed import (
    N_LOC, S, STREAM, W, _alive_rows, _pump_sharded, _sharded_state,
)
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)


def _budgets():
    return StreamingBudgets(max_activations_per_frame=4, max_despawns_per_frame=512,
                            max_entities=STREAM)


def _port_rows(state):
    class A:
        pass
    s = A()
    s.transform, s.render = A(), A()
    s.transform.pos = state.transform.pos.numpy()
    s.render.mesh_id = state.render.mesh_id.numpy()
    s.sector, s.alive = state.sector.numpy(), state.alive.numpy()
    return _alive_rows(s)


def test_streamed_strips_match_scx():
    from scx.core.config import StreamingBudgets as JB, WorldPartitionConfig as JC

    jcfg = JC(load_radius=1, unload_radius=2)
    jsbs = JSBS(jmake_mesh(dp=1, sp=S), _sharded_state(), jcfg,
                JB(max_activations_per_frame=4, max_despawns_per_frame=512, max_entities=STREAM),
                x0=0.0, shard_width=W, stream_rows=STREAM)
    cfg = WorldPartitionConfig(load_radius=1, unload_radius=2)
    mesh = tm.make_mesh(dp=1, sp=S, device="cpu")
    sbs = StreamedBigScene(mesh, ent.alloc_entity_state(N_LOC, S, "cpu"), cfg, _budgets(),
                           x0=0.0, shard_width=W, stream_rows=STREAM)
    try:
        for cam, want_sectors in (((64.0, 0.0, 32.0), {(cx, cz) for cx in (0, 1)
                                                      for cz in (-1, 0, 1)}),
                                  ((64.0, 0.0, 32.0 + 4 * W), {(cx, cz) for cx in (0, 1)
                                                               for cz in (3, 4, 5)})):
            _pump_sharded(jsbs, cam, 6, frames=240)
            _pump_sharded(sbs, cam, 6, frames=240)
            assert sbs.active_sectors() == jsbs.active_sectors() == want_sectors
            for k, p in enumerate(sbs.partitions):
                for c, sec in p.sectors.items():
                    if sec.state.name == "ACTIVE":
                        assert sbs.strip_of_sector(c, cfg.sector_size_meters) == k
            got = _port_rows(sbs.state)
            want = _alive_rows(jax.tree.map(np.asarray, jsbs.state))
            assert got.shape == want.shape and len(got) > 0
            np.testing.assert_array_equal(got, want)
            alive = sbs.state.alive.numpy()
            for k, p in enumerate(sbs.partitions):
                np.testing.assert_array_equal(alive[k, :STREAM], p._alive)
                assert not alive[k, STREAM:].any()
            # uids stay unique over the whole world
            uid = sbs.state.uid[sbs.state.alive]
            assert torch.unique(uid).numel() == uid.numel()
            assert int(uid.min()) >= S * N_LOC
    finally:
        sbs.shutdown()
        jsbs.shutdown()
