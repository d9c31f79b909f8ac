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

// the SAT kernel has no barrier: its threads run one after another
extern "C" int emu_sat(const float* ga, const float* gb, const float* pvf, float* fk, int* cand,
                       float* fp, int e, int p, int box_only) {
  blockDim.x = SAT_THREADS;
  long long total = (long long)e * p;
  for (long long b = 0; b * SAT_THREADS < total; ++b)
    for (int t = 0; t < SAT_THREADS; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = t;
      if (box_only) planar_sat_kernel<true>(ga, gb, pvf, fk, cand, fp, e, p);
      else planar_sat_kernel<false>(ga, gb, pvf, fk, cand, fp, e, p);
    }
  return 0;
}

extern "C" int emu_solve(const float* jac, const int* ia, const int* ib, const float* vw0,
                         float* vw, float* lam, int e, int n, int p, int iterations) {
  if (solve_smem_bytes(n, p) > sizeof(smem_words)) return 1;
  for (int b = 0; b < e; ++b)
    emu_block(b, SOLVE_THREADS,
              [&] { planar_solve_kernel(jac, ia, ib, vw0, vw, lam, n, p, iterations); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    so = torch_planar_emu.build(SRC, _TAIL, tmp_path_factory.mktemp("emu"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    so.emu_sat.argtypes = [vp] * 6 + [i32] * 3
    so.emu_solve.argtypes = [vp] * 6 + [i32] * 4
    so.emu_layout.argtypes = [ctypes.POINTER(i32)]
    return so


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
    fk = torch.empty((8, envs, 4, pairs))
    cand = torch.empty((envs, 4, pairs), dtype=torch.int32)
    fp = torch.empty((3, envs, pairs))
    rc = emulated.emu_sat(ga.data_ptr(), gb.data_ptr(), pvf.data_ptr(), fk.data_ptr(),
                          cand.data_ptr(), fp.data_ptr(), envs, pairs,
                          int(kinds == ("box",)))
    assert rc == 0
    ref = tp.sat_reference(ga, gb, pvf, kinds)
    assert torch.equal(fk[7], ref[7]) and ref[7].sum() > 0
    assert torch.equal(cand, ref[8])
    for got, want in zip(fk[:7], ref[:7]):
        torch.testing.assert_close(got, want, rtol=0, atol=5e-6)
    for got, want in zip(fp, ref[9:]):
        assert torch.equal(got, want)
    if triggers:
        assert ref[11].sum() > 0


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
    vw = torch.empty_like(vw0)
    lam = torch.empty((envs, 12, pairs))
    ia, ib, vw0 = ia.contiguous(), ib.contiguous(), vw0.contiguous()
    rc = emulated.emu_solve(jac.data_ptr(), ia.data_ptr(), ib.data_ptr(), vw0.data_ptr(),
                            vw.data_ptr(), lam.data_ptr(), envs, bodies, pairs,
                            params.iterations)
    assert rc == 0
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
    vw = torch.empty_like(vw0)
    lam = torch.empty((4, 12, 128))
    ia, ib, vw0 = ia.contiguous(), ib.contiguous(), vw0.contiguous()
    rc = emulated.emu_solve(jac.data_ptr(), ia.data_ptr(), ib.data_ptr(), vw0.data_ptr(),
                            vw.data_ptr(), lam.data_ptr(), 4, 64, 128, iterations)
    assert rc == 0
    vw_r, lam_r = tp.solve_reference(jac, ia, ib, vw0, iterations)
    assert torch.equal(vw, vw_r) and torch.equal(lam, lam_r)
