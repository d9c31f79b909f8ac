"""The CUDA middle kernel's source, run on the CPU against middle_reference.

The device part of csrc/planar_middle.cu (everything above its host entry
points, with the shared header csrc/planar_device.cuh) is plain C++ apart from a few CUDA keywords. Built with g++ and a
small shim (one host thread per CUDA thread, std::barrier for
__syncthreads, one block at a time), it runs here without a GPU, so the
kernel's logic is checked on every run; on the card tests/
test_torch_cuda_middle.py checks the nvcc build. Same contract as
tests/test_torch_planar_middle.py.
"""

import ctypes
import shutil
import subprocess
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams

SRC = Path(tp.__file__).resolve().parent / "csrc" / "planar_middle.cu"
ALL_KINDS = ("box", "sphere", "capsule")

_SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstddef>
#include <math.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__
struct emu_dim { unsigned x, y, z; };
thread_local emu_dim threadIdx;
static emu_dim blockIdx, blockDim;
static std::barrier<>* emu_bar;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
namespace { alignas(16) float smem_words[1 << 18]; }
#include "device_part.inc"

template <bool B>
static void emu_run(const float* rows, const int* ia, const int* ib, const float* pvf,
                    const float* prev, const float* vw0, float* vwc, float* lam, float* cand,
                    float* valid, float* trig, int e, int n, int p, int it, float bs,
                    float slop, float rt, float rel, float ws) {
  blockDim.x = p;
  for (int b = 0; b < e; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(p);
    emu_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < p; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        planar_middle_kernel<B>(rows, ia, ib, pvf, prev, vw0, vwc, lam, cand, valid, trig,
                                n, p, it, bs, slop, rt, rel, ws);
      });
    for (auto& th : ts) th.join();
  }
}

extern "C" int emu_middle(const float* rows, const int* ia, const int* ib, const float* pvf,
                          const float* prev, const float* vw0, float* vwc, float* lam,
                          float* cand, float* valid, float* trig, int e, int n, int p,
                          int box_only, int it, float bs, float slop, float rt, float rel,
                          float ws) {
  if (smem_bytes(n, p) > sizeof(smem_words)) return 1;
  if (box_only)
    emu_run<true>(rows, ia, ib, pvf, prev, vw0, vwc, lam, cand, valid, trig, e, n, p, it, bs,
                  slop, rt, rel, ws);
  else
    emu_run<false>(rows, ia, ib, pvf, prev, vw0, vwc, lam, cand, valid, trig, e, n, p, it, bs,
                   slop, rt, rel, ws);
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("emu")
    (d / "cuda_runtime.h").write_text("")
    (d / "device_part.inc").write_text(SRC.read_text().split("// ---- host entry points")[0])
    for header in SRC.parent.glob("*.cuh"):  # the device code shared between the kernels
        shutil.copy(header, d)
    (d / "emu.cpp").write_text(_SHIM)
    lib = d / "libemu.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         f"-I{d}", "-o", str(lib), str(d / "emu.cpp")],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.emu_middle.argtypes = [vp] * 11 + [i32] * 5 + [f32] * 5
    so.emu_middle.restype = i32
    return so


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
