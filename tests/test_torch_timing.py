"""scx_torch.timing.kernel_ms's sessions, on a stand-in profiler: a session
that traced no launch of the kernel is run again, and the helper raises
only when every session traced none."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from scx_torch import timing


def _profiler(sessions):
    """A torch.profiler.profile stand-in whose k-th session reports the
    device events sessions[k] (kernel names, each 10 us)."""
    runs = iter(sessions)

    @contextlib.contextmanager
    def profile(activities):
        names = next(runs)
        yield SimpleNamespace(events=lambda: [
            SimpleNamespace(name=n, device_type=torch.autograd.DeviceType.CUDA,
                            time_range=SimpleNamespace(elapsed_us=lambda: 10.0))
            for n in names])

    return profile


@pytest.mark.parametrize("sessions,want", [
    ([["void k_kernel<1>"]], 0.01),
    ([[], ["other"], ["void k_kernel<1>", "void k_kernel<1>"]], 0.01),
    ([[], [], []], None),
])
def test_kernel_ms_runs_a_lost_session_again(monkeypatch, sessions, want):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", _profiler(sessions))
    calls = []
    fn = lambda: calls.append(1)
    if want is None:
        with pytest.raises(RuntimeError, match="no launch traced in 3 sessions"):
            timing.kernel_ms(fn, 4, "k_kernel")
    else:
        assert timing.kernel_ms(fn, 4, "k_kernel") == pytest.approx(want)
    assert len(calls) == 1 + 4 * len(sessions)  # a warm-up, then reps a session
