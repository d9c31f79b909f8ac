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

import numpy as np
import torch

from scx_torch.physics import planar as tp
from scx_torch.physics.rigid import make_bodies
from scx_torch.physics.warmstart import key_match

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
#define __noinline__
#define __restrict__ __restrict
#define __shared__
#define __launch_bounds__(...)
using std::min;
struct emu_dim { unsigned x, y, z; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
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


def _quat(rng, n, tilt):
    """n unit quaternions (w, x, y, z): rotations by up to `tilt` radians
    about random axes."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = rng.uniform(0, tilt, size=(n, 1)) / 2
    return np.concatenate([np.cos(half), axis * np.sin(half)], axis=1)


def _rows(pos, quat, shape, size, rng):
    """Gathered SAT rows [14, n] (planar._sat_rows order), random friction,
    restitution and a trigger on one body in seven."""
    n = len(pos)
    return np.concatenate([
        pos.T, quat.T, np.full((1, n), shape), size.T,
        rng.uniform(0.2, 1.0, (2, n)), (rng.random((1, n)) < 1 / 7),
    ]).astype(np.float32)


def sat_case(name, pairs=128, device="cpu"):
    """Fleet SAT operands (ga, gb [2, 14, P], pvf [2, P]) and shape kinds of
    one of SAT_CASES, from a seeded numpy generator; the pairs of kinds other
    than box-box are boxes, capsules and spheres:

    * no-pair-valid: random box pairs (some overlap, some do not), and
      capsules and spheres touching boxes, whose candidate 0 has a depth
      > 0; pvf 0;
    * all-pair-valid: random box pairs, pvf 1;
    * few-candidates: tilted boxes whose lowest corner or edge dips into a
      slab (1 to 3 candidates valid), in every other slot;
    * equal-depths: boxes flat on a slab (4 face candidates of one depth),
      and capsules and spheres flat on a box (probes of one depth: 5
      candidates tie or nearly), pvf 1; one sphere's depth overflows to
      +inf (kept with its id, not valid)."""
    rng = np.random.default_rng(SAT_CASES.index(name))
    n = 2 * pairs
    h_a = rng.uniform(0.2, 0.8, (n, 3))
    h_b = rng.uniform(0.2, 0.8, (n, 3))
    pos_a = rng.uniform(-2, 2, (n, 3))
    q_a, q_b = _quat(rng, n, np.pi), _quat(rng, n, np.pi)
    shape_a = shape_b = 0
    kinds = ("box",)
    pvf = np.ones(n)
    if name in ("no-pair-valid", "all-pair-valid"):
        gap = rng.uniform(0.3, 1.3, (n, 1)) * (np.linalg.norm(h_a + h_b, axis=1, keepdims=True))
        off = rng.normal(size=(n, 3))
        pos_b = pos_a + off / np.linalg.norm(off, axis=1, keepdims=True) * gap
        pvf[:] = name == "all-pair-valid"
    else:  # B rests on A, a slab with its top face at y = pos_a.y + h_a.y
        h_a[:, [0, 2]] = 3.0
        q_a = _quat(rng, n, 0.0)
        if name == "few-candidates":
            q_b = _quat(rng, n, 1.2)
            pvf[1::2] = 0
        else:
            q_b = _quat(rng, n, 0.0)
        # B's lowest point sits `dip` below A's top face
        rot = _rotations(q_b)
        support = np.abs(rot[:, 1, :] * h_b).sum(1)
        dip = rng.uniform(0.001, 0.05, n)
        pos_b = pos_a + rng.uniform(-1, 1, (n, 3)) * [1, 0, 1]
        pos_b[:, 1] = pos_a[:, 1] + h_a[:, 1] + support - dip
    ga = _rows(pos_a, q_a, shape_a, h_a, rng)
    gb = _rows(pos_b, q_b, shape_b, h_b, rng)
    if name in ("no-pair-valid", "equal-depths"):  # the second env: spheres and capsules
        kinds = ("box", "sphere", "capsule")
        r = h_b[pairs:, 0]
        half = np.where(np.arange(pairs) % 2, 0.0, h_b[pairs:, 1])  # spheres have none
        lie = np.tile([np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)], (pairs, 1))  # axis along x
        gb[3:7, pairs:] = lie.T
        gb[7, pairs:] = np.where(np.arange(pairs) % 2, 1, 2)
        gb[8, pairs:], gb[9, pairs:], gb[10, pairs:] = r, half, r
        gb[1, pairs:] = ga[1, pairs:] + ga[9, pairs:] + r - rng.uniform(0.001, 0.05, pairs)
        ga[7, pairs:] = 0
        swap = np.arange(pairs, n, 3)  # the capsule or sphere as body A in some slots
        ga[:, swap], gb[:, swap] = gb[:, swap].copy(), ga[:, swap].copy()
        if name == "equal-depths":  # a sphere of radius 3e38 inside a box as large
            ga[8:11, pairs + 1] = gb[8, pairs + 1] = gb[10, pairs + 1] = 3e38
    shape = lambda x: torch.from_numpy(x.reshape(14, 2, pairs).transpose(1, 0, 2).copy())
    pvf = torch.from_numpy(pvf.reshape(2, pairs).astype(np.float32))
    return shape(ga).to(device), shape(gb).to(device), pvf.to(device), kinds


SAT_CASES = ("no-pair-valid", "all-pair-valid", "few-candidates", "equal-depths")


def _rotations(q):
    """Rotation matrices [n, 3, 3] of unit quaternions (w, x, y, z)."""
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def check_sat_case(name, pvf, ref):
    """Asserts that sat_case(name)'s operands reach what the case is for,
    from sat_reference's outputs `ref`."""
    valid, depth = ref[7] > 0.5, ref[6]
    nvalid = valid.sum(1)                                  # [E, P]
    if name == "no-pair-valid":  # candidate 0 is still written, touching or not
        assert pvf.sum() == 0 and not bool(valid.any()) and (depth[1, 0] > 0).any()
    elif name == "all-pair-valid":
        assert bool((pvf > 0.5).all()) and (nvalid > 0).any() and (nvalid == 0).any()
    elif name == "few-candidates":
        few = (nvalid > 0) & (nvalid < 4)
        assert few.sum() > 10 and not bool(valid.any(1)[pvf < 0.5].any())
    else:  # equal depths in consecutive entries, box pairs and capsule/sphere pairs alike
        tie = valid[:, 1:] & valid[:, :-1] & (depth[:, 1:] == depth[:, :-1])
        assert tie.any(2).any(1).all()
        assert depth[1, 0, 1] == float("inf") and not valid[1, 0, 1] and ref[8][1, 0, 1] == 2


def warm_case(envs, pairs, keys="rows", pairs_old=None, seed=0, device="cpu"):
    """A warm-start cache and this step's keys for the key match (planar.
    _warm_prev), from a seeded numpy generator: (cache, ka, kb, pair_valid).

    Keys are body pairs of a few bodies (keys="rows": body indices, so
    stored keys repeat) or of uids past 2^24 (keys="uids", planar._pair_keys
    with key_id), some a float32 apart, some equal in their low 24 bits. The cache holds, at random, empty slots (both keys -1),
    slots with one key -1, and copies of earlier slots' keys further on
    (duplicates: the lowest stored slot must win). This step's slots take a
    stored slot's keys (hits, also where pair_valid is False), fresh keys
    (misses) or -1 keys with pair_valid True (which must not match the
    empty slots); the records hold -0.0, inf and NaN among their floats."""
    rng = np.random.default_rng([seed, envs, pairs, pairs_old or pairs, keys == "uids"])
    p_old = pairs_old or pairs
    if keys == "rows":
        key = lambda *shape: rng.integers(0, 8, shape)
    else:  # neighbours past 2^24 (one float32), and keys equal below bit 24
        key = lambda *shape: 2**24 * rng.integers(1, 64, shape) + rng.integers(0, 64, shape)
    ka_old, kb_old = key(envs, p_old), key(envs, p_old)
    dup = rng.random((envs, p_old)) < 0.1  # an earlier slot's keys again
    src = (rng.random((envs, p_old)) * np.arange(p_old)).astype(np.int64)
    ka_old = np.where(dup, np.take_along_axis(ka_old, src, 1), ka_old)
    kb_old = np.where(dup, np.take_along_axis(kb_old, src, 1), kb_old)
    empty = rng.random((envs, p_old))
    ka_old[empty < 0.25] = -1
    kb_old[empty < 0.20] = -1
    kb_old[(empty > 0.95)] = -1  # key_a kept, key_b empty
    pick = rng.integers(0, p_old, (envs, pairs))
    ka, kb = key(envs, pairs), key(envs, pairs)
    take = rng.random((envs, pairs))
    hit = take < 0.6
    ka = np.where(hit, np.take_along_axis(ka_old, pick, 1), ka)
    kb = np.where(hit, np.take_along_axis(kb_old, pick, 1), kb)
    ka[take > 0.95] = -1
    kb[take > 0.97] = -1
    pair_valid = rng.random((envs, pairs)) < 0.8
    rec = lambda: rng.standard_normal((envs, 4, p_old)).astype(np.float32)
    lam = [rec(), rec(), rec()]
    lam[0][0, 0, :3] = [-0.0, np.inf, np.nan]
    t = lambda x, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(x)).to(dt).to(device)
    cache = tp.PlanarCache(
        key_a=t(ka_old), key_b=t(kb_old),
        cand=t(rng.integers(-1, 10, (envs, 4, p_old))),
        lam_n=t(lam[0], torch.float32), lam_1=t(lam[1], torch.float32),
        lam_2=t(lam[2], torch.float32),
    )
    return cache, t(ka), t(kb), t(pair_valid, torch.bool)


def check_warm_case(cache, ka, kb, pair_valid, ref):
    """Asserts that a warm_case reaches what it is for, from
    planar.warm_prev_reference's record `ref` (CPU tensors)."""
    hit, _ = key_match(ka, kb, pair_valid, cache.key_a, cache.key_b)
    assert hit.any() and (~hit & pair_valid).any()
    assert (ref[:, :4][hit[:, None].expand(-1, 4, -1)] > 0).any()  # matched cand + 1
    eq = ((ka[..., :, None] == cache.key_a[..., None, :])
          & (kb[..., :, None] == cache.key_b[..., None, :]))
    assert (eq & ~pair_valid[..., None]).any()  # invalid pairs with a stored pair's keys
    assert (eq.sum(-1) > 1).any()  # duplicates among the stored keys
    assert (eq & (cache.key_a == -1)[..., None, :] & pair_valid[..., None]).any()  # -1 keys


def warm_bits_equal(got, want) -> bool:
    """Two float records equal bit for bit (-0.0 and NaN payloads too)."""
    return torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))
