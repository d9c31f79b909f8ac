"""The host runtime of the port (scx_torch.core.jobs / timing / log /
memtrack, scx_torch.telemetry, scx_torch.state.scheduler) against scx's
where scx's tests hold its own: the job system (test_rlenv_checkpoint.py::
test_job_system), named scopes, the telemetry overlay text
(test_app_sandbox.py::test_debug_overlay_formats), memtrack
(test_core_memtrack.py), trace on the CPU profiler (test_telemetry_trace.py)
and the scheduler, compose_tick's masked fixed steps included
(test_scheduler.py). Tolerance: exact (equal text, counters and values)."""

import glob
import os

import numpy as np
import pytest
import torch

from torch_render_scenes import one_torch_thread  # noqa: F401

from scx_torch.core import jobs as tjobs
from scx_torch.core import memtrack as tmem
from scx_torch.core import timing as ttiming
from scx_torch.state.scheduler import FixedStepClock, Phase, Scheduler
from scx_torch.telemetry import FrameTelemetry, TelemetryHub, trace


def test_job_system():
    js = tjobs.JobSystem(workers=2)
    acc = np.zeros(100, np.int64)

    def work(i):
        acc[i] = i * i

    js.dispatch(100, 16, work)
    np.testing.assert_array_equal(acc, np.arange(100) ** 2)
    fut = js.dispatch_async(lambda: 41 + 1)
    assert fut.result() == 42
    stats = js.begin_frame()
    assert stats.dispatched == 7 and stats.async_jobs == 1 and stats.completed == 7
    js.shutdown()


def test_scopes_drain_top_n():
    ttiming.snapshot_top_scopes()
    for name, n in (("A", 3), ("B", 1), ("C", 2)):
        for _ in range(n):
            with ttiming.ScopedTimer(f"Test/{name}"):
                sum(range(20000))
    top = [s.name for s in ttiming.snapshot_top_scopes(2)]
    assert len(top) == 2 and set(top) <= {"Test/A", "Test/B", "Test/C"}
    assert ttiming.snapshot_top_scopes() == []  # drained


def test_telemetry_overlay_matches_scx():
    from scx.telemetry import TelemetryHub as JHub

    rng = np.random.default_rng(5)
    for health in (False, True):
        hubs = (TelemetryHub(), JHub())
        for hub in hubs:
            hub.begin_frame(7)
        vals = {f: int(rng.integers(0, 5000)) for f in (
            "entities", "draws", "visible", "active_sectors", "queued_sectors",
            "loading_sectors", "stream_activations", "stream_despawns", "traffic_total",
            "traffic_physics", "traffic_kinematic", "traffic_onrails", "traffic_spawns",
            "traffic_stuck", "resident_textures", "resident_bytes", "texture_evictions",
            "broadphase_pairs", "contacts", "pair_overflow", "device_hbm_bytes",
            "host_rss_bytes")}
        vals.update(invalid_state=int(health), teleports=2 * int(health), sim_ms=1.25,
                    render_ms=3.5, stream_ms=0.75, top_scopes=[("System/X", 1.5)],
                    mem_tags={"State": 123456, "Assets": 654321})
        for hub in hubs:
            for k, v in vals.items():
                setattr(hub.current, k, v)
            hub.current.wall_ms, hub.current.fps = 16.0, 62.5
        assert hubs[0].format_overlay() == hubs[1].format_overlay()
        text = hubs[0].format_overlay()
        assert "entities" in text and "traffic" in text and "sectors" in text
        assert ("STATE HEALTH" in text) == health
    t = hubs[0].end_frame()
    assert isinstance(t, FrameTelemetry) and hubs[0].averages()["fps"] == t.fps


def test_memtrack_matches_scx():
    from scx.core import memtrack as jmem

    for mod in (tmem, jmem):
        mod.reset()
        mod.track(mod.TAG_PHYSICS, 1024, "contacts")
        mod.track(mod.TAG_PHYSICS, 2048, "bodies")
        mod.untrack(mod.TAG_PHYSICS, 1024)
        for i in range(mod.RING_CAPACITY + 10):
            mod.track(mod.TAG_CORE, i, f"a{i}")
    assert tmem.snapshot() == {k: tmem.TagCounters(**vars(v)) for k, v in jmem.snapshot().items()}
    assert [vars(r) for r in tmem.recent_allocs(4)] == [vars(r) for r in jmem.recent_allocs(4)]
    assert tmem.total_live_bytes() == jmem.total_live_bytes()

    tree_np = {"a": np.zeros((8, 4), np.float32), "b": np.zeros((3,), np.int32)}
    tree_t = {k: torch.from_numpy(v) for k, v in tree_np.items()}
    assert tmem.track_array(tmem.TAG_STATE, tree_t) == jmem.track_array(jmem.TAG_STATE, tree_np)
    assert tmem.retrack_array(tmem.TAG_STATE, tree_t, tree_t["a"]) == 8 * 4 * 4
    assert tmem.snapshot()[tmem.TAG_STATE].live_bytes == 8 * 4 * 4

    from scx_torch.state.entity import alloc_entity_state

    tmem.reset()
    alloc_entity_state(64, 2, device="cpu")
    assert tmem.snapshot()[tmem.TAG_STATE].live_bytes > 2 * 64 * 3 * 4
    assert tmem.host_rss_bytes() > 1 << 20
    assert tmem.device_memory_stats("cpu") == {}  # as scx on a backend without stats
    tmem.track(tmem.TAG_RENDERER, 123456, "fb")
    text = tmem.format_snapshot()
    assert "Renderer" in text and "MiB" in text
    tmem.reset()


def test_trace_captures_on_the_cpu_profiler(tmp_path):
    logdir = str(tmp_path / "tr")
    with trace.annotate("nope"):  # no trace live: a no-op
        pass
    trace.start_trace(logdir)
    assert trace.tracing_active()
    with trace.annotate("System/TestSpan"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    trace.stop_trace()
    assert not trace.tracing_active()
    files = [f for f in glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
             if os.path.isfile(f)]
    assert files and "System/TestSpan" in open(files[0]).read()


def test_scheduler_order_deps_and_clock():
    order = []
    mk = lambda name: (lambda state, ctx: order.append(name) or state)
    s = Scheduler()
    s.add_system("c", Phase.SIMULATION, mk("c"), deps=("b",))
    s.add_system("a", Phase.SIMULATION, mk("a"))
    s.add_system("b", Phase.SIMULATION, mk("b"), deps=("a",))
    s.add_system("x", Phase.RENDER, mk("x"), deps=("y",))
    s.add_system("y", Phase.RENDER, mk("y"), deps=("x",))
    with pytest.raises(ValueError):
        s.add_system("x", Phase.INPUT, mk("x"))
    s.finalize()
    assert [d.name for d in s.phase_systems(Phase.SIMULATION)] == ["a", "b", "c"]
    assert [d.name for d in s.phase_systems(Phase.RENDER)] == ["x", "y"]  # fallback
    s.tick_eager(torch.zeros(()), {"fixed_dt": 0.1}, fixed_steps=2)
    assert order == ["a", "b", "c", "x", "y"]
    assert set(s.stats_ms) == {"a", "b", "c", "x", "y"}

    from scx.state.scheduler import FixedStepClock as JClock

    clocks = (FixedStepClock(fixed_dt=1 / 60, max_substeps=4), JClock(fixed_dt=1 / 60,
                                                                      max_substeps=4))
    for dt in (1 / 60, 3 / 60, 0.5 / 60, 1.0, 2.5 / 60, 1 / 144):
        assert clocks[0].advance(dt) == clocks[1].advance(dt)
        assert clocks[0].accumulator == clocks[1].accumulator
    clocks[0].paused = True
    assert clocks[0].advance(1 / 60) == 1


@pytest.mark.parametrize("n_steps", [0, 1, 3, 4])
def test_compose_tick_masks_fixed_steps_as_scx(n_steps):
    import jax
    import jax.numpy as jnp

    from scx.state.scheduler import Phase as JPhase
    from scx.state.scheduler import Scheduler as JScheduler

    def build(sched, phase, xp, dt_key):
        sched.add_system("accumulate", phase.FIXED_UPDATE,
                         lambda st, ctx: {"x": st["x"] + ctx[dt_key],
                                          "n": st["n"] + xp.where(ctx["step_active"], 1, 0)})
        sched.add_system("double", phase.RENDER_PREP,
                         lambda st, ctx: {"x": st["x"] * 2.0, "n": st["n"]})
        return sched.finalize().compose_tick(max_fixed_steps=4)

    t_tick = build(Scheduler(), Phase, torch, "dt")
    j_tick = jax.jit(build(JScheduler(), JPhase, jnp, "dt"))
    t = t_tick({"x": torch.tensor(0.5), "n": torch.tensor(0)},
               {"fixed_dt": torch.tensor(0.25), "n_fixed_steps": torch.tensor(n_steps)})
    j = j_tick({"x": jnp.asarray(0.5), "n": jnp.asarray(0)},
               {"dt": 0.0, "fixed_dt": jnp.asarray(0.25), "n_fixed_steps": jnp.int32(n_steps)})
    assert float(t["x"]) == float(j["x"]) == (0.5 + 0.25 * n_steps) * 2.0
    assert int(t["n"]) == int(j["n"]) == n_steps
