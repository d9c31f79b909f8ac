"""The CUDA middle kernel against its plain PyTorch version, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_middle.py
The contract is that of tests/test_torch_planar_middle.py."""

from dataclasses import replace

import pytest
import torch

from scx_torch import _build
from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams

import torch_planar_emu

pytestmark = pytest.mark.cuda
ALL_KINDS = ("box", "sphere", "capsule")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the middle kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", [
    (64, 24, 128, ALL_KINDS, False),
    (16, 24, 37, ALL_KINDS, True),
    (128, 64, 128, ("box",), False),
    (8, 64, 256, ("box",), False),
    (8, 512, 128, ("box",), False),
    (64, 512, 128, ("box",), False),
    (4, 1250, 128, ("box",), False),
])
def test_kernel_matches_plain(gpu, envs, bodies, pairs, kinds, triggers):
    params = SolverParams(max_pairs=pairs, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(envs, bodies, gpu)
    else:
        b = fleet.build_mixed_fleet(envs, bodies, 5, gpu)
    if triggers:
        b = replace(b, trigger=(torch.arange(bodies, device=gpu) % 7 == 3).expand(envs, -1))
    cache = tp.empty_planar_cache(envs, pairs, device=gpu)
    for _ in range(3):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    _, ops, _ = tp.middle_operands(b, params, cache)
    ref = _check(ops, params)
    if triggers:
        assert ref[4].sum() > 0


def test_kernel_takes_every_branch(gpu):
    """Envs with no pair, with pair-valid slots and no contact, with more
    live pairs than the register rounds hold, and a pile whose live contacts
    span more than one warp (tests/test_torch_middle_emulated.py)."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = torch_planar_emu.cat_fleets(torch_planar_emu.lattice_fleet([3.0, 1.01, 0.98], device=gpu),
                                    fleet.build_pile_fleet(1, 64, gpu))
    cache = tp.empty_planar_cache(4, 128, device=gpu)
    for _ in range(3):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    _, ops, _ = tp.middle_operands(b, params, cache)
    live = (_check(ops, params)[3].sum(1) > 0).sum(1)  # live pairs per env
    assert live[0] == 0 and live[1] == 0 and live[2] > 64 and live[3] > 8


def _check(ops, params):
    """The kernel against the plain version on ops (the contract of
    tests/test_torch_planar_middle.py); returns the plain version's outputs."""
    kinds = params.shape_kinds
    before = tp.MIDDLE_KERNEL_LAUNCHES
    ker = [x.cpu() for x in tp.middle(*ops, params)]
    assert tp.MIDDLE_KERNEL_LAUNCHES == before + 1
    ref = [x.cpu() for x in tp.middle_reference(*ops, params)]
    vwc_k, lam_k, cand_k, val_k, trig_k = ker
    vwc_r, lam_r, cand_r, val_r, trig_r = ref
    flips = val_k != val_r
    if flips.any():
        rows, ia, ib, pvf = ops[:4]
        depth = tp._sat_top_k(tp._gather(rows, ia.long()), tp._gather(rows, ib.long()),
                              pvf > 0.5, kinds)[2]
        assert torch.stack(depth, -2).abs().cpu()[flips].max() < 1e-5
    both = (val_k > 0.5) & (val_r > 0.5)
    assert both.sum() > 0
    assert torch.equal(cand_k[both], cand_r[both])
    assert torch.equal(trig_k, trig_r)
    torch.testing.assert_close(vwc_k, vwc_r, rtol=0, atol=5e-5)
    torch.testing.assert_close(lam_k, lam_r, rtol=0, atol=5e-4)
    return ref


def test_kernel_rejects_bad_operands(gpu):
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(4, 64, gpu)
    _, ops, _ = tp.middle_operands(b, params, tp.empty_planar_cache(4, 128, device=gpu))
    bad = list(ops)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError):
        tp.middle(*bad, params)
    bad = list(ops)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        tp.middle(*bad, params)
    wide = SolverParams(max_pairs=2048, iterations=6, shape_kinds=("box",))
    _, ops, _ = tp.middle_operands(b, wide, tp.empty_planar_cache(4, 2048, device=gpu))
    with pytest.raises(ValueError, match="cannot take"):
        tp.middle(*ops, wide)


def test_kernel_limits(gpu):
    """The shapes the wrapper takes: at least N=1,250 at P=128 and P=330 at
    N=64 (the one-thread-per-slot kernel's limits); one past the shared
    memory the card gives a block raises."""
    lib = _build.load()
    opt_in = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    n_max = max(n for n in range(1, 20000) if lib.scx_planar_middle_smem_bytes(n, 128) <= opt_in)
    p_max = max(p for p in range(1, 5000) if lib.scx_planar_middle_smem_bytes(64, p) <= opt_in)
    assert n_max >= 1250 and p_max >= 330
    for nb, p in ((n_max, 128), (64, p_max)):
        tp._middle_check_shape(gpu.index, 1, nb, p)
    for nb, p in ((n_max + 1, 128), (64, p_max + 1)):
        with pytest.raises(ValueError, match="cannot take"):
            tp._middle_check_shape(gpu.index, 1, nb, p)


def test_forced_plain_route_matches_fused_route(gpu):
    """On the card, a step forced onto the plain route (a shared-memory
    limit below both kernels' needs) launches the SAT kernel and the solve
    kernel with its work in global memory, not the middle, and stays
    within the middle's contract of the fused route's step from the same
    warm state: velocities 5e-5, impulses 5e-4, contact ids exact where
    both are valid."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(64, 24, gpu)
    cache = tp.empty_planar_cache(64, 128, device=gpu)
    for _ in range(10):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    limit = tp.solve_smem_bytes(24, 128) - 1
    assert tp.step_route(24, 128, gpu, smem_limit=limit) == "plain"
    launches, routes = tp.MIDDLE_KERNEL_LAUNCHES, dict(tp.STEP_ROUTES)
    sat, solve = tp.SAT_KERNEL_LAUNCHES, tp.SOLVE_KERNEL_LAUNCHES
    bp, cp, sp = tp.step_planar_cached(b, params, cache, smem_limit=limit)
    torch.cuda.synchronize()
    assert tp.MIDDLE_KERNEL_LAUNCHES == launches
    assert (tp.SAT_KERNEL_LAUNCHES, tp.SOLVE_KERNEL_LAUNCHES) == (sat + 1, solve + 1)
    assert tp.STEP_ROUTES["plain"] == routes["plain"] + 1
    bf, cf, sf = tp.step_planar_cached(b, params, cache)
    assert tp.MIDDLE_KERNEL_LAUNCHES == launches + 1
    for f in ("vel", "omega"):
        for u, v in zip(getattr(bp, f), getattr(bf, f)):
            torch.testing.assert_close(u, v, rtol=0, atol=5e-5)
    both = (cp.cand >= 0) & (cf.cand >= 0)
    assert torch.equal(cp.cand[both], cf.cand[both])
    for f in ("lam_n", "lam_1", "lam_2"):
        torch.testing.assert_close(getattr(cp, f), getattr(cf, f), rtol=0, atol=5e-4)
    assert int(sp["contacts"].sum()) > 0
