"""The metric arithmetic on synthetic data: a whole-window rate, a p95 over
every step, an idle share from intervals, a roofline from counted bytes."""

import pytest
import torch

from portbench import bounds, stats
from portbench.metrics import (_roofline, device_idle_share, launches_per_step,
                               torch_ops_ms_per_step)
from portbench.run import Run, Window
from portbench.trace import Trace


def test_rate_is_the_whole_window():
    assert stats.rate(4096 * 250, 40.0) == 4096 * 250 / 40.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (40, 50)]
    assert stats.union_us(iv, 0, 45) == 15 + 10 + 5
    assert stats.gaps(iv, -5, 55) == [(-5, 0), (15, 20), (30, 40), (50, 55)]


def synthetic_run(steps=2):
    device = [("planar_middle_kernel<true>", 10.0, 30.0), ("elementwise_kernel add", 40.0, 50.0),
              ("elementwise_kernel add", 45.0, 60.0), ("tile_raster_kernel", 80.0, 90.0)]
    host = [("portbench.step", 0.0, 100.0), ("aten::mul", 60.0, 80.0),
            ("cudaLaunchKernel", 62.0, 70.0)]
    trace = Trace(window=(0.0, 100.0), device=device, host=host)
    return Run(workload={}, config={}, window=Window(10, 1.0, 0),
               trace=trace, traced_steps=steps)


def test_idle_share_from_intervals():
    run = synthetic_run()
    assert run.trace.busy_us == 20 + 20 + 10
    assert device_idle_share.read(run) == pytest.approx(0.5)
    assert launches_per_step.read(run) == 2.0
    # PyTorch's ops: the two adds, 25 us over 2 steps
    assert torch_ops_ms_per_step.read(run) == pytest.approx(25e-3 / 2)
    gaps = dict(run.trace.idle_gaps())
    assert gaps["portbench.step / cudaLaunchKernel"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)
    assert run.trace.device_ops()[0] == ["elementwise_kernel add", 25e-6]


def test_roofline_from_counted_bytes():
    ms, by = bounds.bound(3.35e9, 1.0)          # 3.35 GB at 3.35 TB/s
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = bounds.bound(1.0, 67e9)            # 67 GFLOP at 67 TFLOP/s
    assert by == "operations" and ms == pytest.approx(1.0)
    run = synthetic_run()                       # one middle launch of 20 us
    assert _roofline.share(run, "planar_middle_kernel", 0.01) == pytest.approx(50.0)
    assert _roofline.share(run, "planar_sat_kernel", 0.01) is None   # nothing to read
    assert _roofline.share(run, "planar_middle_kernel", None) is None


def test_kernel_bounds_count_bytes_and_operations():
    w = {"envs": 1, "bodies": 2, "slots": 1, "pairs": 1, "pair_bodies": 2, "live_pairs": 1,
         "contacts": 1, "narrow_ops": 0.0, "setup_ops": 0.0, "sweep_ops": 0.0}
    # ia, ib, pvf; velocities in (6 rows) and out (7); impulses and the
    # three candidate planes of K = 4 slots; 21 rows of the two bodies;
    # the 16-row warm-start record of the pair; 4 bytes each
    moved = 4 * (3 + 6 * 2 + 7 * 2 + 12 + 12 + 21 * 2 + 16)
    assert bounds.middle_bound(w) == (pytest.approx(moved / 3.35e12 * 1e3), "bytes")
    assert bounds.middle_bound({**w, "sweep_ops": 67e9})[1] == "operations"
    assert bounds.count_ops(lambda: torch.ones(10) + torch.ones(10)) == 10
    assert bounds.count_ops(lambda: torch.ones(4, 5).sum(-1)) == 20


def test_readers_return_nothing_without_a_trace():
    run = Run(workload={}, config={}, window=Window(1, 1.0, 0))
    for m in (device_idle_share, launches_per_step, torch_ops_ms_per_step):
        assert m.read(run) is None
