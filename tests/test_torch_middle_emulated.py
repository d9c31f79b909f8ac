"""The CUDA middle kernel's source, run on the CPU against middle_reference.

The device part of csrc/planar_middle.cu (everything above its host entry
points, with the shared header csrc/planar_device.cuh), built with g++
and the shim of tests/torch_planar_emu.py (one host thread per CUDA
thread of the env's 4-warp CTA; barriers for __syncthreads, __syncwarp
and the named barrier of the live warps; warp votes, shuffles and
matches), runs here without a GPU, so the kernel's logic is checked on
every run; on the card tests/test_torch_cuda_middle.py checks the nvcc
build. Same contract as tests/test_torch_planar_middle.py; the case that
takes every branch (no pair, no contact, the overflow rounds, padding
next to live slots) must give the reference's bits.
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
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

SRC = Path(tp.__file__).resolve().parent / "csrc" / "planar_middle.cu"
ALL_KINDS = ("box", "sphere", "capsule")

_TAIL = r"""
extern "C" long long emu_smem(int n, int p) { return (long long)middle_smem_bytes(n, p); }

extern "C" int emu_middle(const float* rows, const int* ia, const int* ib, const float* pvf,
                          const float* prev, const float* vw0, float* vwc, float* lam,
                          float* cand, float* valid, float* trig, int e, int n, int p,
                          int box_only, int it, float bs, float slop, float rt, float rel,
                          float ws) {
  if (middle_smem_bytes(n, p) > sizeof(smem_words)) return 1;
  for (int b = 0; b < e; ++b)
    emu_block(b, MID_THREADS, [&] {
      if (box_only)
        planar_middle_kernel<true>(rows, ia, ib, pvf, prev, vw0, vwc, lam, cand, valid, trig,
                                   n, p, it, bs, slop, rt, rel, ws);
      else
        planar_middle_kernel<false>(rows, ia, ib, pvf, prev, vw0, vwc, lam, cand, valid, trig,
                                    n, p, it, bs, slop, rt, rel, ws);
    });
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    so = torch_planar_emu.build(SRC, _TAIL, tmp_path_factory.mktemp("emu"))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.emu_middle.argtypes = [vp] * 11 + [i32] * 5 + [f32] * 5
    so.emu_middle.restype = i32
    so.emu_smem.argtypes = [i32, i32]
    so.emu_smem.restype = ctypes.c_longlong
    return so


def test_smem_layout_matches_python(emulated):
    """The step's route is decided in Python from the middle's shared memory
    per env (planar.middle_smem_bytes): the same bytes as the kernel's
    middle_layout, on both sides of the staging overlay (P <= 80) and at
    the limits its header states."""
    for n, p in ((64, 128), (64, 80), (64, 81), (1, 1), (704, 2048), (6351, 128),
                 (64, 1010), (4096, 256), (576, 256)):
        assert emulated.emu_smem(n, p) == tp.middle_smem_bytes(n, p), (n, p)
    assert tp.middle_smem_bytes(6351, 128) <= tp.H100_OPTIN_SMEM < tp.middle_smem_bytes(6352, 128)
    assert tp.middle_smem_bytes(64, 1010) <= tp.H100_OPTIN_SMEM < tp.middle_smem_bytes(64, 1011)


def _run(so, ops, params):
    rows, ia = ops[0], ops[1]
    e, _, n = rows.shape
    p = ia.shape[-1]
    outs = [torch.empty((e, 7, n)), torch.empty((e, 12, p))]
    outs += [torch.empty((e, 4, p)) for _ in range(3)]
    rc = so.emu_middle(
        *(x.data_ptr() for x in ops), *(o.data_ptr() for o in outs), e, n, p,
        int(tuple(params.shape_kinds) == ("box",)), params.iterations,
        params.baumgarte / params.dt, params.slop, params.restitution_threshold,
        params.relaxation, params.warm_start)
    assert rc == 0
    return outs


@pytest.mark.parametrize("envs,bodies,pairs,kinds,triggers", [
    (6, 24, 128, ALL_KINDS, False),
    (4, 24, 37, ALL_KINDS, True),
    (4, 64, 128, ("box",), False),
    (2, 150, 64, ALL_KINDS, False),
    (2, 512, 128, ("box",), False),
])
def test_kernel_source_matches_reference(emulated, envs, bodies, pairs, kinds, triggers):
    params = SolverParams(max_pairs=pairs, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(envs, bodies, "cpu")
    else:
        b = fleet.build_mixed_fleet(envs, bodies, 7, "cpu")
    if triggers:
        b = replace(b, trigger=(torch.arange(bodies) % 7 == 3).expand(envs, -1))
    cache = tp.empty_planar_cache(envs, pairs, device="cpu")
    for _ in range(3):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    _, ops, _ = tp.middle_operands(b, params, cache)
    ops = [x.contiguous() for x in ops]
    ker = _run(emulated, ops, params)
    ref = tp.middle_reference(*ops, params)
    vwc_k, lam_k, cand_k, val_k, trig_k = ker
    vwc_r, lam_r, cand_r, val_r, trig_r = ref
    assert torch.equal(val_k, val_r)
    assert val_r.sum() > 0
    assert torch.equal(cand_k, cand_r)
    assert torch.equal(trig_k, trig_r)
    if triggers:
        assert trig_r.sum() > 0
    torch.testing.assert_close(vwc_k, vwc_r, rtol=0, atol=5e-5)
    torch.testing.assert_close(lam_k, lam_r, rtol=0, atol=5e-4)


def test_kernel_source_takes_every_branch(emulated):
    """Four envs of a lattice fleet after one warm step: no broadphase pair;
    pair-valid slots with no contact; more live pairs than the register
    rounds hold (the overflow rounds, all 4 warps); a pile with live
    contacts on more than one warp, whose slots past the broadphase's pairs
    are padding next to live ones. The slots with no valid contact are left
    out of the sweeps and the lists; the reference adds their updates,
    which are +-0 only while their invariants are finite: checked on the
    same contacts' solve pack. Then the kernel must give the reference's
    bits."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = torch_planar_emu.cat_fleets(torch_planar_emu.lattice_fleet([3.0, 1.01, 0.98]),
                                    fleet.build_pile_fleet(1, 64, "cpu"))
    cache = tp.empty_planar_cache(4, 128, device="cpu")
    for _ in range(3):
        b, cache, _ = tp.step_planar_cached(b, params, cache)
    b1, ops, _ = tp.middle_operands(b, params, cache)
    ops = [x.contiguous() for x in ops]
    ker = _run(emulated, ops, params)
    ref = tp.middle_reference(*ops, params)
    pair_valid = ops[3] > 0.5
    live = ref[3].sum(1) > 0                       # [E, P] slots with a valid contact
    assert pair_valid[0].sum() == 0
    assert pair_valid[1].sum() > 0 and live[1].sum() == 0
    assert live[2].sum() > 64                      # 4 x 64 register contacts per CTA
    assert 8 < live[3].sum() <= 64 and not pair_valid[3].all()
    ia, ib = ops[1], ops[2]
    con = tp.planar_contacts(b1, ia, ib, pair_valid, params.shape_kinds)
    jac, _, _ = tp.solve_pack(b1, con, params, ia, ib, None)
    assert torch.isfinite(jac.permute(0, 2, 1)[~live]).all()
    for got, want in zip(ker, ref):
        assert torch.equal(got, want)
