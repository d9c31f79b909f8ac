"""The staged kernels' source, run on the CPU against their plain versions.

The device part of csrc/planar_staged.cu (everything above its host entry
points, with the shared header csrc/planar_device.cuh), built with g++
and the shim of tests/torch_planar_emu.py (one host thread per CUDA
thread, one block at a time; the solve kernel's warp intrinsics and
barriers emulated), runs the fleet SAT and the fleet solve here without
a GPU; on the card tests/test_torch_cuda_staged.py checks the nvcc build.
The shared header is the one the fused middle kernel is built from
(tests/test_torch_middle_emulated.py).
"""

import ctypes
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams

import torch_planar_emu

SRC = Path(tp.__file__).resolve().parent / "csrc" / "planar_staged.cu"
ALL_KINDS = ("box", "sphere", "capsule")

_TAIL = r"""
extern "C" void emu_layout(int* out) { planar_layout(out); }

extern "C" long long emu_solve_smem(int n, int p) { return (long long)solve_smem_bytes(n, p); }

extern "C" int emu_sat(const float* ga, const float* gb, const float* pvf, unsigned* out, int e,
                       int p, int box_only) {
  long long total = (long long)e * p;
  for (long long b = 0; b * SAT_SLOTS < total; ++b)
    emu_block((int)b, SAT_THREADS, [&] {
      if (box_only) planar_sat_kernel<true>(ga, gb, pvf, out, e, p);
      else planar_sat_kernel<false>(ga, gb, pvf, out, e, p);
    });
  return 0;
}

extern "C" int emu_solve(const float* jac, const int* ia, const int* ib, const float* vw0,
                         float* vw, float* lam, float* work, int e, int n, int p,
                         int iterations) {
  if (!work && solve_smem_bytes(n, p) > sizeof(smem_words)) return 1;
  for (int b = 0; b < e; ++b)
    emu_block(b, SOLVE_THREADS, [&] {
      if (work) planar_solve_kernel<true>(jac, ia, ib, vw0, vw, lam, work, n, p, iterations);
      else planar_solve_kernel<false>(jac, ia, ib, vw0, vw, lam, nullptr, n, p, iterations);
    });
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    so = torch_planar_emu.build(SRC, _TAIL, tmp_path_factory.mktemp("emu"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    so.emu_sat.argtypes = [vp] * 4 + [i32] * 3
    so.emu_solve.argtypes = [vp] * 7 + [i32] * 4
    so.emu_layout.argtypes = [ctypes.POINTER(i32)]
    so.emu_solve_smem.argtypes = [i32, i32]
    so.emu_solve_smem.restype = ctypes.c_longlong
    return so


def test_solve_smem_layout_matches_python(emulated):
    """The staged route is taken where the fleet solve's shared memory per
    env (planar.solve_smem_bytes) fits: the same bytes as the kernel's
    solve_layout, at the limits its header states."""
    for n, p in ((64, 128), (1, 1), (704, 2048), (7916, 128), (64, 2745), (512, 256)):
        assert emulated.emu_solve_smem(n, p) == tp.solve_smem_bytes(n, p), (n, p)
    assert tp.solve_smem_bytes(7916, 128) <= tp.H100_OPTIN_SMEM < tp.solve_smem_bytes(7917, 128)
    assert tp.solve_smem_bytes(64, 2745) <= tp.H100_OPTIN_SMEM < tp.solve_smem_bytes(64, 2746)


def test_cuda_layout_matches_python(emulated):
    """K, the candidate count, the SAT rows and the solve pack's layout have
    one definition in Python and one in csrc/planar_device.cuh."""
    theirs = (ctypes.c_int * len(tp.python_layout()))()
    emulated.emu_layout(theirs)
    assert list(theirs) == tp.python_layout()
    assert tp._SOLVE_R == 168 and tp._K == 4 and tp._N_CAND == 10


def _warm_fleet(envs, bodies, pairs, kinds, triggers, steps=3):
    params = SolverParams(max_pairs=pairs, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(envs, bodies, "cpu")
    else:
        b = fleet.build_mixed_fleet(envs, bodies, 7, "cpu")
    if triggers:
        b = replace(b, trigger=(torch.arange(bodies) % 7 == 3).expand(envs, -1))
    cache = tp.empty_planar_cache(envs, pairs, device="cpu")
    for _ in range(steps):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    b = tp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, _ = tp.planar_broadphase(b, pairs)
    return b, cache, params, ia, ib, pair_valid


def _emu_sat(so, ga, gb, pvf, kinds):
    """The kernel source's 12 outputs, split from its one buffer as
    planar.sat_fleet splits them."""
    e, _, p = ga.shape
    out = torch.empty(tp._SAT_WORDS * e * p)
    ga, gb, pvf = (x.contiguous() for x in (ga, gb, pvf))
    assert so.emu_sat(ga.data_ptr(), gb.data_ptr(), pvf.data_ptr(), out.data_ptr(), e, p,
                      int(tuple(kinds) == ("box",))) == 0
    n = e * 4 * p
    *fk, cand = out[:9 * n].view(9, e, 4, p)
    return (*fk, cand.view(torch.int32), *out[9 * n:].view(3, e, p))


def _check_sat(got, ref):
    """At every slot, pair-valid or not: validity, candidate ids, friction,
    restitution and trigger equal; point, normal and depth within 5e-6 (the
    same formulas in the same order, so in fact equal up to libm's
    sqrt/division, which both sides round correctly)."""
    for i in (7, 8, 9, 10, 11):
        assert torch.equal(got[i], ref[i]), i
    for g, r in zip(got[:7], ref[:7]):
        torch.testing.assert_close(g, r, rtol=0, atol=5e-6)


def _emu_solve(so, jac, ia, ib, vw0, iterations, work_in_global=False):
    """The solve kernel source's (vw, lam); work_in_global runs the
    template that keeps each env's words in a buffer (filled with NaN, so
    a word read before it is written shows) rather than shared memory."""
    e, _, p = jac.shape
    n = vw0.shape[-1]
    vw = torch.empty((e, 6, n))
    lam = torch.empty((e, 12, p))
    work = torch.full((e, tp.solve_smem_bytes(n, p) // 4), float("nan")) if work_in_global else None
    jac, ia, ib, vw0 = (x.contiguous() for x in (jac, ia.int(), ib.int(), vw0))
    assert so.emu_solve(jac.data_ptr(), ia.data_ptr(), ib.data_ptr(), vw0.data_ptr(),
                        vw.data_ptr(), lam.data_ptr(), None if work is None else work.data_ptr(),
                        e, n, p, iterations) == 0
    return vw, lam


CASES = [
    (6, 24, 128, ALL_KINDS, False),
    (4, 24, 37, ALL_KINDS, True),
    (4, 64, 128, ("box",), False),
    (2, 150, 64, ALL_KINDS, False),
    (2, 512, 128, ("box",), False),
]


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", CASES)
def test_sat_kernel_source_matches_reference(emulated, envs, bodies, pairs, kinds, triggers):
    """Discrete outputs equal on every slot (invalid ones too); floats within
    5e-6 (the same formulas in the same order, so they are in fact equal
    up to libm's sqrt/division, which both sides round correctly)."""
    b, _, _, ia, ib, pair_valid = _warm_fleet(envs, bodies, pairs, kinds, triggers)
    ga, gb, pvf = (x.contiguous() for x in tp._sat_inputs(b, ia, ib, pair_valid))
    ref = tp.sat_reference(ga, gb, pvf, kinds)
    assert ref[7].sum() > 0
    _check_sat(_emu_sat(emulated, ga, gb, pvf, kinds), ref)
    if triggers:
        assert ref[11].sum() > 0


@pytest.mark.parametrize("pairs", [128, 37])
@pytest.mark.parametrize("case", torch_planar_emu.SAT_CASES)
def test_sat_kernel_source_edge_cases(emulated, case, pairs):
    """Slots that are not pair-valid (candidate 0 in every entry), envs
    whose slots are all pair-valid, pairs with fewer than 4 valid candidates
    (the rest repeat candidate 0 with id 0) and equal depths (the lower
    candidate first): equal to sat_reference at every slot, through the
    kernel's 16-byte stores (P = 128) and its one-word stores (P = 37); box
    pairs through both of its templates."""
    ga, gb, pvf, kinds = torch_planar_emu.sat_case(case, pairs)
    for k in {kinds, ALL_KINDS}:
        ref = tp.sat_reference(ga, gb, pvf, k)
        torch_planar_emu.check_sat_case(case, pvf, ref)
        _check_sat(_emu_sat(emulated, ga, gb, pvf, k), ref)


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", CASES)
def test_solve_kernel_source_matches_reference(emulated, envs, bodies, pairs, kinds, triggers):
    """vw and lam within 2e-5 of solve_reference on a warm pack (the contract
    scx holds its solve kernel to against its own core)."""
    b, cache, params, ia, ib, pair_valid = _warm_fleet(envs, bodies, pairs, kinds, triggers)
    con = tp.planar_contacts(b, ia, ib, pair_valid, kinds)
    lam0 = tp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = tp.solve_pack(b, con, params, ia, ib, lam0)
    assert tuple(jac.shape) == (envs, 168, pairs) and jac.is_contiguous()
    assert sum(x.abs().sum() for x in lam0) > 0  # the warm start is live
    vw, lam = _emu_solve(emulated, jac, ia, ib, vw0, params.iterations)
    vw_r, lam_r = tp.solve_reference(jac, ia, ib, vw0, params.iterations)
    assert lam_r.abs().sum() > 0
    torch.testing.assert_close(vw, vw_r, rtol=0, atol=2e-5)
    torch.testing.assert_close(lam, lam_r, rtol=0, atol=2e-5)


@pytest.mark.parametrize("iterations", [6, 0])
def test_solve_kernel_source_takes_every_branch(emulated, iterations):
    """Four envs after three staged steps: no broadphase pair; pair-valid
    slots with no contact; more live pairs than the register rounds hold
    (the overflow rounds); a pile with live contacts on more than one warp
    and padded slots next to live ones. The slots with no valid contact are
    left out of the sweeps and the lists; the reference adds their updates,
    which are +-0 while their pack columns are finite (checked). The kernel
    must give the reference's bits, with no sweep as well."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = torch_planar_emu.cat_fleets(torch_planar_emu.lattice_fleet([3.0, 1.01, 0.98]),
                                    fleet.build_pile_fleet(1, 64, "cpu"))
    cache = tp.empty_planar_cache(4, 128, device="cpu")
    for _ in range(3):
        b, cache, _ = tp.step_planar_staged(b, params, cache)
    b = tp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, _ = tp.planar_broadphase(b, 128)
    con = tp.planar_contacts(b, ia, ib, pair_valid, params.shape_kinds)
    lam0 = tp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = tp.solve_pack(b, con, params, ia, ib, lam0)
    live = con.valid.any(1)
    assert pair_valid[0].sum() == 0
    assert pair_valid[1].sum() > 0 and live[1].sum() == 0
    assert live[2].sum() > 64                      # 4 x 64 register contacts per CTA
    assert 8 < live[3].sum() <= 64 and not pair_valid[3].all()
    assert torch.isfinite(jac.permute(0, 2, 1)[~live]).all()
    vw, lam = _emu_solve(emulated, jac, ia, ib, vw0, iterations)
    vw_r, lam_r = tp.solve_reference(jac, ia, ib, vw0, iterations)
    assert torch.equal(vw, vw_r) and torch.equal(lam, lam_r)


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", [
    CASES[0], CASES[2], (4, 64, 2800, ("box",), False)])
def test_solve_kernel_source_with_global_work(emulated, envs, bodies, pairs, kinds, triggers):
    """The solve's global-memory template (the "plain" step route's, where
    one env's words exceed a block's shared memory: 64 x 2800 needs 237,016
    B of the H100's 232,448) gives the shared-memory template's bits on the
    same pack, every env at its own offset of the buffer, and so stays
    within 2e-5 of solve_reference."""
    b, cache, params, ia, ib, pair_valid = _warm_fleet(envs, bodies, pairs, kinds, triggers)
    con = tp.planar_contacts(b, ia, ib, pair_valid, kinds)
    lam0 = tp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = tp.solve_pack(b, con, params, ia, ib, lam0)
    vw_g, lam_g = _emu_solve(emulated, jac, ia, ib, vw0, params.iterations, work_in_global=True)
    vw_s, lam_s = _emu_solve(emulated, jac, ia, ib, vw0, params.iterations)
    assert torch.equal(vw_g, vw_s) and torch.equal(lam_g, lam_s)
    vw_r, lam_r = tp.solve_reference(jac, ia, ib, vw0, params.iterations)
    assert lam_r.abs().sum() > 0
    torch.testing.assert_close(vw_g, vw_r, rtol=0, atol=2e-5)
    torch.testing.assert_close(lam_g, lam_r, rtol=0, atol=2e-5)
