"""The port's spans (scx_torch.telemetry.trace.annotate / span) and the
physics step's stage spans (scx_torch.physics.planar).

A span records only while a torch profiler records: then it is a
FUNCTION-scope host event, nested under its caller and not a user
annotation, kept in a bounded log with its device interval where CUDA is
initialised. With no profiler it is a shared null context and touches
neither the log nor CUDA. The `cuda` test runs on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_trace_spans.py
and holds that the spans add no device operation to a traced step."""

from collections import Counter

import pytest
import torch

from torch_render_scenes import one_torch_thread  # noqa: F401

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams
from scx_torch.telemetry import trace

ACTS = [torch.profiler.ProfilerActivity.CPU]
STAGES = {
    "fused": ["physics.broadphase", "physics.key_match", "physics.middle", "physics.store",
              "physics.finish"],
    "staged": ["physics.broadphase", "physics.contacts", "physics.key_match",
               "physics.solve_pack", "physics.solve", "physics.store", "physics.finish"],
}


@pytest.fixture(autouse=True)
def empty_log():
    trace.clear_spans()
    yield
    trace.clear_spans()


def test_annotate_is_off_without_a_profiler(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a span touched CUDA with no profiler recording")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    assert trace.annotate("a") is trace.annotate("b")  # one shared null context
    with trace.annotate("a"):
        pass
    assert trace.span("c")(lambda x: x + 1)(1) == 2
    assert trace.spans() == [] and trace.dropped_spans() == 0


def test_a_span_is_a_nested_cpu_event_not_a_user_annotation():
    with torch.profiler.profile(activities=ACTS) as prof:
        with trace.annotate("outer.span"):
            with trace.annotate("inner.span"):
                torch.ones(8).sum()
    events = {e.name: e for e in prof.events() if e.name.endswith(".span")}
    assert set(events) == {"outer.span", "inner.span"}
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
    assert events["inner.span"].cpu_parent.name == "outer.span"
    outer, inner = trace.spans()
    assert (outer.name, inner.name) == ("outer.span", "inner.span")
    assert outer.parent is None and inner.parent == outer.seq
    assert outer.host_start_ns <= inner.host_start_ns <= inner.host_end_ns <= outer.host_end_ns
    assert outer.device_ms is None  # CUDA not initialised here


def test_the_log_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "_log", trace.SpanLog(max_spans=3))
    with torch.profiler.profile(activities=ACTS):
        for i in range(5):
            with trace.annotate(f"s{i}"):
                pass
    assert [s.name for s in trace.spans()] == ["s2", "s3", "s4"]
    assert trace.dropped_spans() == 2
    trace.clear_spans()
    assert trace.spans() == [] and trace.dropped_spans() == 0


def _fleet(envs=2, bodies=12, pairs=32):
    params = SolverParams(max_pairs=pairs, iterations=2, shape_kinds=("box",))
    b = fleet.build_pile_fleet(envs, bodies, "cpu")
    cache = tp.empty_planar_cache(envs, pairs, device="cpu")
    b, cache, _ = fleet.rollout(b, cache, params, 2)
    return b, cache, params


def _tree(spans):
    """[(step, [its children's names])] of the recorded spans."""
    steps = [s for s in spans if s.name == "physics.step"]
    assert all(s.parent is None for s in steps)
    return [(s, [c.name for c in spans if c.parent == s.seq]) for s in steps]


@pytest.mark.parametrize("route", ["fused", "staged", "cached_to_staged"])
def test_a_step_gives_the_stage_spans_once_per_step(route):
    b, cache, params = _fleet()
    n, p = b.n, params.max_pairs
    if route == "cached_to_staged":  # the fused step's staged route: one physics.step
        limit = tp.middle_smem_bytes(n, p) - 1
        assert tp.step_route(n, p, "cpu", smem_limit=limit) == "staged"
        step = lambda b, params, cache: tp.step_planar_cached(b, params, cache,
                                                              smem_limit=limit)
    else:
        step = {"fused": tp.step_planar_cached, "staged": tp.step_planar_staged}[route]
    with torch.profiler.profile(activities=ACTS) as prof:
        fleet.rollout(b, cache, params, 3, step_fn=step)
    tree = _tree(trace.spans())
    assert len(tree) == 3
    want = STAGES["fused" if route == "fused" else "staged"]
    assert all(children == want for _, children in tree)
    names = Counter(e.name for e in prof.events() if e.name.startswith("physics."))
    assert names == Counter({"physics.step": 3, **{s: 3 for s in want}})


def test_spans_leave_the_step_unchanged(monkeypatch):
    b, cache, params = _fleet()
    plain = tp.step_planar_staged(b, params, cache)
    with torch.profiler.profile(activities=ACTS):
        traced = tp.step_planar_staged(b, params, cache)
    assert torch.equal(plain[0].pos.x, traced[0].pos.x)
    assert torch.equal(plain[1].lam_n, traced[1].lam_n)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "staged"])
def test_spans_add_no_device_operation_on_the_card(monkeypatch, route):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the step's kernels have no CPU mode)")
    gpu = torch.device("cuda", 0)
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(256, 64, gpu)
    cache = tp.empty_planar_cache(256, 128, device=gpu)
    step = {"fused": tp.step_planar_cached, "staged": tp.step_planar_staged}[route]
    b, cache, _ = fleet.rollout(b, cache, params, 3, step_fn=step)
    torch.cuda.synchronize()
    acts = ACTS + [torch.profiler.ProfilerActivity.CUDA]

    def device_ops():
        with torch.profiler.profile(activities=acts) as prof:
            fleet.rollout(b, cache, params, 2, step_fn=step)
            torch.cuda.synchronize()
        return Counter(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)

    with_spans = device_ops()
    spans = trace.spans()
    monkeypatch.setattr(trace, "_recording", lambda: False)
    without = device_ops()
    assert with_spans == without and sum(without.values()) > 0
    assert not any(n.startswith("physics.") for n in with_spans)
    assert [len(c) for _, c in _tree(spans)] == [len(STAGES[route])] * 2
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in spans)
    assert trace.spans()[-1].seq == spans[-1].seq  # nothing recorded with spans off
