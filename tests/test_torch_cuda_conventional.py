"""The conventional step (scx_torch.physics.step_bodies_cached) on the card
against the same code on the CPU, and against itself.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_conventional.py
The step is plain PyTorch on both devices (scx's is plain XLA): the card
differs from the CPU only in the order of its sums (the one-hot products'
matmuls, the reductions), so each step from the same state holds the
tolerances of the CPU tests against scx (tests/test_torch_physics_solver.py):
stats equal, validity flips only at graze pairs (such an env is not
compared in that step), positions within 1e-5, velocities and impulses
within 1e-4. Two runs on the card are bit for bit the same."""

import pytest
import torch

from scx_torch import physics as cph
from scx_torch.physics import fleet
from scx_torch.physics import planar as pp

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the step's card-vs-CPU check)")
    return torch.device("cuda", 0)


def _run(b, params, steps):
    cache = cph.empty_contact_cache(b.active.shape[0], params.max_pairs, device=b.pos.device)
    for _ in range(steps):
        b, cache, _ = cph.step_bodies_cached(b, params, cache)
    return b, cache


@pytest.mark.parametrize("colors", [0, 4])
def test_step_on_card_matches_cpu(gpu, colors):
    """A 16 x 24 mixed fleet (boxes, spheres, capsules), 30 steps on the
    card, then 5 steps each also run on the CPU from the card's state
    (chip_smoke.py's phase 14.2, which fails on a stat or a flip off
    graze depth)."""
    import chip_smoke

    params = cph.SolverParams(max_pairs=64, iterations=8, colors=colors)
    b = _run(pp.rigid_from_planar(fleet.build_mixed_fleet(16, 24, 5, gpu)), params, 30)[0]
    err, compared, _ = chip_smoke.conventional_resynced(b, params, 5, torch.device("cpu"))
    assert compared >= 40
    assert err["pos"] <= 1e-5 and err["quat"] <= 1e-5, err
    assert err["vel"] <= 1e-4 and err["omega"] <= 1e-4 and err["lam"] <= 1e-4, err


def test_step_on_card_is_deterministic(gpu):
    """Two runs of the mixed fleet and of 64 envs of the pile (box-only)
    on the card are bit for bit the same: the per-body sums are one-hot
    matmuls, with no float atomics."""
    for b, kinds in ((pp.rigid_from_planar(fleet.build_mixed_fleet(16, 24, 5, gpu)),
                      ("box", "sphere", "capsule")),
                     (pp.rigid_from_planar(fleet.build_pile_fleet(64, 64, gpu)), ("box",))):
        params = cph.SolverParams(max_pairs=128, iterations=6, shape_kinds=kinds)
        (b1, c1), (b2, c2) = _run(b, params, 30), _run(b, params, 30)
        for f in ("pos", "quat", "vel", "omega", "sleep_timer"):
            assert torch.equal(getattr(b1, f), getattr(b2, f)), f
        for f in ("key_a", "key_b", "cand", "lam"):
            assert torch.equal(getattr(c1, f), getattr(c2, f)), f
