"""The CUDA fleet SAT and fleet solve kernels against their plain PyTorch
versions, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_staged.py
The SAT kernel equals its plain version at every slot, pair-valid or not:
validity, candidate ids, friction, restitution and trigger bit for bit,
the floats within 5e-6 (in practice equal), as in
tests/test_torch_staged_emulated.py; the solve within 2e-5 (the contract
of tests/test_torch_planar_staged.py)."""

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
CASES = [
    (64, 24, 128, ALL_KINDS, False),
    (16, 24, 37, ALL_KINDS, True),
    (128, 64, 128, ("box",), False),
    (8, 64, 256, ("box",), False),
    (8, 512, 128, ("box",), False),
    (64, 512, 128, ("box",), False),
]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the staged kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _warm(gpu, envs, bodies, pairs, kinds, triggers):
    params = SolverParams(max_pairs=pairs, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(envs, bodies, gpu)
    else:
        b = fleet.build_mixed_fleet(envs, bodies, 5, gpu)
    if triggers:
        b = replace(b, trigger=(torch.arange(bodies, device=gpu) % 7 == 3).expand(envs, -1))
    cache = tp.empty_planar_cache(envs, pairs, device=gpu)
    for _ in range(3):
        b, cache, _ = tp.step_planar_staged(b, params, cache)
    b = tp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, _ = tp.planar_broadphase(b, pairs)
    return b, cache, params, ia, ib, pair_valid


def _check_sat(ga, gb, pvf, kinds):
    """sat_fleet (one launch) against sat_reference at every slot."""
    before = tp.SAT_KERNEL_LAUNCHES
    ker = [x.cpu() for x in tp.sat_fleet(ga, gb, pvf, kinds)]
    assert tp.SAT_KERNEL_LAUNCHES == before + 1
    ref = [x.cpu() for x in tp.sat_reference(ga, gb, pvf, kinds)]
    for i in (7, 8, 9, 10, 11):
        assert torch.equal(ker[i], ref[i]), i
    for got, want in zip(ker[:7], ref[:7]):
        torch.testing.assert_close(got, want, rtol=0, atol=5e-6)
    return ref


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", CASES)
def test_sat_kernel_matches_plain(gpu, envs, bodies, pairs, kinds, triggers):
    b, _, _, ia, ib, pair_valid = _warm(gpu, envs, bodies, pairs, kinds, triggers)
    ref = _check_sat(*tp._sat_inputs(b, ia, ib, pair_valid), kinds)
    assert ref[7].sum() > 0
    if triggers:
        assert ref[11].sum() > 0


def test_sat_kernel_matches_plain_on_the_pile(gpu):
    """The main shape, 1024 x 64 at P = 128, after 3 warm steps and after
    240, when the pile has settled (more pair-valid slots per env)."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(1024, 64, gpu)
    cache = tp.empty_planar_cache(1024, 128, device=gpu)
    for steps in (3, 237):
        for _ in range(steps):
            b, cache, _ = tp.step_planar_staged(b, params, cache)
        b1 = tp.planar_integrate_velocities(b, params.dt, params.gravity)
        ia, ib, pair_valid, _ = tp.planar_broadphase(b1, 128)
        ref = _check_sat(*tp._sat_inputs(b1, ia, ib, pair_valid), ("box",))
        assert ref[7].sum() > 0 and not bool(pair_valid.all())


@pytest.mark.parametrize("pairs", [128, 37])
@pytest.mark.parametrize("case", torch_planar_emu.SAT_CASES)
def test_sat_kernel_edge_cases(gpu, case, pairs):
    """tests/test_torch_staged_emulated.py's cases: no pair-valid slot, all
    pair-valid, fewer than 4 valid candidates, equal depths; box pairs
    through both templates."""
    ga, gb, pvf, kinds = torch_planar_emu.sat_case(case, pairs, gpu)
    for k in {kinds, ALL_KINDS}:
        ref = _check_sat(ga, gb, pvf, k)
        torch_planar_emu.check_sat_case(case, pvf.cpu(), ref)


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", CASES)
def test_solve_kernel_matches_plain(gpu, envs, bodies, pairs, kinds, triggers):
    b, cache, params, ia, ib, pair_valid = _warm(gpu, envs, bodies, pairs, kinds, triggers)
    con = tp.planar_contacts(b, ia, ib, pair_valid, kinds)
    lam0 = tp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = tp.solve_pack(b, con, params, ia, ib, lam0)
    before = tp.SOLVE_KERNEL_LAUNCHES
    vw_k, lam_k = (x.cpu() for x in tp.solve_fleet(jac, ia, ib, vw0, params.iterations))
    assert tp.SOLVE_KERNEL_LAUNCHES == before + 1
    vw_r, lam_r = (x.cpu() for x in tp.solve_reference(jac, ia, ib, vw0, params.iterations))
    assert lam_r.abs().sum() > 0
    torch.testing.assert_close(vw_k, vw_r, rtol=0, atol=2e-5)
    torch.testing.assert_close(lam_k, lam_r, rtol=0, atol=2e-5)


def test_solve_kernel_takes_every_branch(gpu):
    """Envs with no pair, with pair-valid slots and no contact, with more
    live pairs than the register rounds hold, and a pile whose live contacts
    span more than one warp (tests/test_torch_staged_emulated.py)."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = torch_planar_emu.cat_fleets(torch_planar_emu.lattice_fleet([3.0, 1.01, 0.98], device=gpu),
                                    fleet.build_pile_fleet(1, 64, gpu))
    cache = tp.empty_planar_cache(4, 128, device=gpu)
    for _ in range(3):
        b, cache, _ = tp.step_planar_staged(b, params, cache)
    b = tp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, _ = tp.planar_broadphase(b, 128)
    con = tp.planar_contacts(b, ia, ib, pair_valid, ("box",))
    lam0 = tp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = tp.solve_pack(b, con, params, ia, ib, lam0)
    live = con.valid.any(1).sum(1).cpu()
    assert live[0] == 0 and live[1] == 0 and live[2] > 64 and live[3] > 8
    vw_k, lam_k = (x.cpu() for x in tp.solve_fleet(jac, ia, ib, vw0, params.iterations))
    vw_r, lam_r = (x.cpu() for x in tp.solve_reference(jac, ia, ib, vw0, params.iterations))
    torch.testing.assert_close(vw_k, vw_r, rtol=0, atol=2e-5)
    torch.testing.assert_close(lam_k, lam_r, rtol=0, atol=2e-5)


def test_staged_step_matches_fused(gpu):
    """20 steps of both paths from one fleet: 99% of envs within 1e-5 (a
    graze flip may move an env)."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b1 = b2 = fleet.build_pile_fleet(256, 64, gpu)
    c1 = c2 = tp.empty_planar_cache(256, 128, device=gpu)
    for _ in range(20):
        b1, c1, _ = tp.step_planar_cached(b1, params, c1)
        b2, c2, _ = tp.step_planar_staged(b2, params, c2)
    dev_env = torch.stack([(x - y).abs() for x, y in zip(b1.pos, b2.pos)]).amax((0, 2))
    assert (dev_env <= 1e-5).float().mean() >= 0.99


def test_kernels_reject_bad_operands(gpu):
    b, cache, params, ia, ib, pair_valid = _warm(gpu, 4, 64, 128, ("box",), False)
    ga, gb, pvf = tp._sat_inputs(b, ia, ib, pair_valid)
    with pytest.raises(ValueError):
        tp.sat_fleet(ga[:, :13].contiguous(), gb, pvf, ("box",))
    con = tp.planar_contacts(b, ia, ib, pair_valid, ("box",))
    jac, vw0, _ = tp.solve_pack(b, con, params, ia, ib, None)
    with pytest.raises(ValueError):
        tp.solve_fleet(jac, ia.long(), ib, vw0, 6)
    wide = torch.zeros((4, 168, 4096), device=gpu)  # past the shared memory of a block
    idx = torch.zeros((4, 4096), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="cannot take"):
        tp.solve_fleet(wide, idx, idx, vw0, 6)


def test_kernels_take_an_empty_fleet(gpu):
    """No envs: neither wrapper launches a zero-sized grid."""
    ga = torch.zeros(0, 14, 8, device=gpu)
    sat = tp.sat_fleet(ga, ga, torch.zeros(0, 8, device=gpu), ("box",))
    assert [tuple(x.shape) for x in sat] == [(0, 4, 8)] * 9 + [(0, 8)] * 3
    idx = torch.zeros(0, 8, dtype=torch.int32, device=gpu)
    vw, lam = tp.solve_fleet(torch.zeros(0, 168, 8, device=gpu), idx, idx,
                             torch.zeros(0, 6, 4, device=gpu), 6)
    assert tuple(vw.shape) == (0, 6, 4) and tuple(lam.shape) == (0, 12, 8)


def test_solve_kernel_limits(gpu):
    """The shapes the wrapper takes: at least N=1,250 at P=128 and P=316 at
    N=64 (the one-thread-per-slot kernel's limits); one past the shared
    memory the card gives a block raises."""
    lib = _build.load()
    opt_in = torch.cuda.get_device_properties(gpu).shared_memory_per_block_optin
    n_max = max(n for n in range(1, 20000) if lib.scx_planar_solve_smem_bytes(n, 128) <= opt_in)
    p_max = max(p for p in range(1, 5000) if lib.scx_planar_solve_smem_bytes(64, p) <= opt_in)
    assert n_max >= 1250 and p_max >= 316
    for nb, p in ((n_max, 128), (64, p_max)):
        tp._solve_check_shape(gpu.index, nb, p)
    for nb, p in ((n_max + 1, 128), (64, p_max + 1)):
        with pytest.raises(ValueError, match="cannot take"):
            tp._solve_check_shape(gpu.index, nb, p)
