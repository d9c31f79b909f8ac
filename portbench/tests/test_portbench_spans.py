"""The span readers' arithmetic on synthetic span records: a stage's device
ms summed over the traced stretch and divided by its `physics.step` spans,
and nothing where the spans cannot say."""

from types import SimpleNamespace

import pytest

from portbench.metrics import (_spans, broadphase_ms_per_step, finish_ms_per_step,
                               key_match_ms_per_step, solve_pack_ms_per_step)
from portbench.run import Run, Window

READERS = {"physics.broadphase": broadphase_ms_per_step,
           "physics.key_match": key_match_ms_per_step,
           "physics.solve_pack": solve_pack_ms_per_step,
           "physics.finish": finish_ms_per_step}


def span(name, ms):
    return SimpleNamespace(name=name, device_ms=ms)


def staged_spans(steps, stage_ms=None):
    """`steps` staged steps' spans; stage i of step s takes (i + 1) * (s + 1) ms."""
    out = []
    for s in range(steps):
        out.append(span("physics.step", 100.0))
        for i, name in enumerate(READERS):
            out.append(span(name, (i + 1) * (s + 1) if stage_ms is None else stage_ms))
    return out


def run_of(steps):
    return Run(workload={}, config={}, window=Window(1, 1.0, 0), traced_steps=steps)


def test_a_stage_is_its_device_ms_over_the_steps():
    spans = staged_spans(3)
    for i, name in enumerate(READERS):
        # (i + 1) * (1 + 2 + 3) ms over 3 steps
        assert _spans.per_step(run_of(3), name, spans) == pytest.approx((i + 1) * 2.0)


@pytest.mark.parametrize("name,reader", READERS.items())
def test_each_reader_reads_its_own_span(monkeypatch, name, reader):
    monkeypatch.setattr(_spans, "records", lambda: staged_spans(2, stage_ms=1.5)
                        + [span("physics.middle", 9.0)])
    assert reader.read(run_of(2)) == pytest.approx(1.5)


def test_nothing_when_the_step_counts_disagree():
    spans = staged_spans(3)
    assert _spans.per_step(run_of(4), "physics.broadphase", spans) is None
    assert _spans.per_step(run_of(3), "physics.broadphase", spans + staged_spans(1)) is None


def test_nothing_without_spans_or_device_intervals():
    assert _spans.per_step(run_of(2), "physics.broadphase", []) is None
    fused = [span("physics.step", 10.0), span("physics.middle", 3.0)] * 2
    assert _spans.per_step(run_of(2), "physics.solve_pack", fused) is None
    cpu = [span("physics.step", None), span("physics.broadphase", None)] * 2
    assert _spans.per_step(run_of(2), "physics.broadphase", cpu) is None
    assert _spans.per_step(run_of(0), "physics.broadphase", staged_spans(0)) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from scx_torch.telemetry import trace

    monkeypatch.delattr(trace, "spans")
    assert _spans.records() is None
    assert broadphase_ms_per_step.read(run_of(10)) is None
