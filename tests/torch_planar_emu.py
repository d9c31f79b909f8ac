"""Helpers for the planar physics kernels' tests: a g++ build of their
device code for a CPU run, and lattice fleets that reach the kernels'
rarer branches.

The device part of a kernel source in scx_torch/physics/csrc (everything
above its host entry points, with the shared header planar_device.cuh) is
plain C++ apart from CUDA keywords, warp intrinsics and one named barrier.
SHIM stands in for those: one host thread per CUDA thread, a std::barrier
for __syncthreads, one std::barrier per warp for __syncwarp and for each
vote, shuffle and match (every lane posts a word, then reads the others'),
and one std::barrier per count of leading warps for the named barrier of
`live_sync`. `emu_block(nthr, fn)` runs fn on the threads of one CTA.
"""

import ctypes
import shutil
import subprocess
from dataclasses import fields, replace
from pathlib import Path

import torch

from scx_torch.physics import planar as tp
from scx_torch.physics.rigid import make_bodies

SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define SCX_PLANAR_SHIM
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__
#define __launch_bounds__(...)
using std::min;
struct emu_dim { unsigned x, y, z; };
// The posting slots rotate, so a slot is written again only after every
// lane has read it (two barrier phases later).
struct EmuWarp {
  std::barrier<> bar{32};
  unsigned slot[2][32];
};
struct EmuCta {
  explicit EmuCta(int nthr) : bar(nthr), warps(nthr / 32) {
    for (int w = 1; w <= nthr / 32; ++w) named.push_back(std::make_unique<std::barrier<>>(32 * w));
  }
  std::barrier<> bar;
  std::vector<EmuWarp> warps;
  std::vector<std::unique_ptr<std::barrier<>>> named;  // [w - 1]: warps 0..w-1
};
thread_local emu_dim threadIdx, blockIdx;
static emu_dim blockDim;
thread_local EmuCta* emu_cta;
thread_local unsigned emu_warp_calls;

inline void __syncthreads() { emu_cta->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_cta->warps[threadIdx.x / 32].bar.arrive_and_wait();
}
// every lane posts a word; all[l] receives lane l's
inline void emu_warp_swap(unsigned v, unsigned* all) {
  EmuWarp& w = emu_cta->warps[threadIdx.x / 32];
  unsigned* slot = w.slot[emu_warp_calls++ % 2];
  slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  std::memcpy(all, slot, 32 * sizeof(unsigned));
}
inline unsigned __ballot_sync(unsigned, int p) {
  unsigned all[32], r = 0;
  emu_warp_swap(p != 0, all);
  for (int l = 0; l < 32; ++l) r |= all[l] << l;
  return r;
}
inline unsigned __match_any_sync(unsigned, int v) {
  unsigned all[32], r = 0;
  emu_warp_swap((unsigned)v, all);
  for (int l = 0; l < 32; ++l) r |= (all[l] == (unsigned)v ? 1u : 0u) << l;
  return r;
}
template <class T>
inline T emu_shfl(T v, int src) {
  unsigned bits, all[32];
  std::memcpy(&bits, &v, 4);
  emu_warp_swap(bits, all);
  T r;
  std::memcpy(&r, &all[src & 31], 4);
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) { return emu_shfl(v, src); }
inline int __shfl_sync(unsigned, int v, int src) { return emu_shfl(v, src); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  return emu_shfl(v, (int)(threadIdx.x % 32) ^ o);
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int lane = threadIdx.x % 32;
  return emu_shfl(v, lane >= (int)d ? lane - (int)d : lane);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float ldg(const float* p) { return *p; }
inline int ldg(const int* p) { return *p; }
inline void live_sync(int nwarps) {
  if (nwarps > 1) emu_cta->named[nwarps - 1]->arrive_and_wait();
  else __syncwarp();
}
namespace { alignas(16) float smem_words[1 << 18]; }
#include "device_part.inc"

// Runs fn() on the nthr threads of one CTA (block b), all at once.
template <class F>
static void emu_block(int b, int nthr, F fn) {
  blockDim.x = nthr;
  EmuCta cta(nthr);
  std::vector<std::thread> ts;
  for (int t = 0; t < nthr; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      blockIdx.x = b;
      emu_cta = &cta;
      fn();
    });
  for (auto& th : ts) th.join();
}
"""


def build(src: Path, tail: str, tmp: Path) -> ctypes.CDLL:
    """g++ build of src's device part, SHIM and `tail` (the test's entry
    points) into a library under tmp."""
    gxx = shutil.which("g++")
    if gxx is None:
        import pytest

        pytest.skip("needs g++ to build the kernel source for the CPU")
    (tmp / "cuda_runtime.h").write_text("")
    (tmp / "device_part.inc").write_text(src.read_text().split("// ---- host entry points")[0])
    for header in src.parent.glob("*.cuh"):  # the device code shared between the kernels
        shutil.copy(header, tmp)
    (tmp / "emu.cpp").write_text(SHIM + tail)
    lib = tmp / "libemu.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         f"-I{tmp}", "-o", str(lib), str(tmp / "emu.cpp")],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib))


def lattice_fleet(spacings, bodies=64, device="cpu") -> tp.PlanarBodies:
    """One env per spacing: `bodies` unit boxes on a cubic lattice that far
    apart, in the air. 3.0 gives no broadphase pair, 1.01 pairs whose boxes
    do not touch (pair-valid, no contact), 0.98 boxes that each overlap
    their neighbours (more live pairs than a CTA's register rounds hold)."""
    side = round(bodies ** (1 / 3))
    assert side ** 3 == bodies
    g = torch.arange(side, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = torch.stack([grid * s + torch.tensor([0.0, 5.0, 0.0]) for s in spacings])
    fleet = tp.planar_from_rigid(make_bodies(pos, size=torch.full(pos.shape, 0.5)))
    return tp.map_tensors(lambda t: t.contiguous().to(device), fleet)


def cat_fleets(*fleets) -> tp.PlanarBodies:
    """The envs of several fleets of one body count, in order."""
    def cat(vs):
        if isinstance(vs[0], tuple):
            return type(vs[0])(*(torch.cat(c) for c in zip(*vs)))
        return torch.cat(vs)

    return replace(fleets[0], **{f.name: cat([getattr(x, f.name) for x in fleets])
                                 for f in fields(fleets[0])})
