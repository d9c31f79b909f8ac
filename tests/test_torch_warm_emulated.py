"""The warm-start key-match kernel's source, run on the CPU against
planar.warm_prev_reference.

The device part of csrc/planar_warm.cu (everything above its host entry
points, with the shared header csrc/planar_device.cuh), built with g++ and
the shim of tests/torch_planar_emu.py (one host thread per CUDA thread, a
barrier for __syncthreads), runs here without a GPU; on the card
tests/test_torch_cuda_warm.py checks the nvcc build. The kernel is a
selection: its record must equal the plain version's bit for bit, -0.0
and NaN payloads included.
"""

import ctypes
from pathlib import Path

import pytest
import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams

import torch_planar_emu
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

SRC = Path(tp.__file__).resolve().parent / "csrc" / "planar_warm.cu"

_TAIL = r"""
extern "C" int emu_warm(const int* ka, const int* kb, const unsigned char* pv, const int* key_a,
                        const int* key_b, const int* cand, const float* lam_n,
                        const float* lam_1, const float* lam_2, float* prev, int e, int p,
                        int p_old) {
  if (warm_smem_bytes() > sizeof(smem_words)) return 1;
  const int chunks = (p + WARM_THREADS - 1) / WARM_THREADS;
  for (long long b = 0; b < (long long)e * chunks; ++b)
    emu_block((int)b, WARM_THREADS, [&] {
      planar_warm_match_kernel(ka, kb, pv, key_a, key_b, cand, lam_n, lam_1, lam_2, prev, p,
                               p_old, chunks);
    });
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    so = torch_planar_emu.build(SRC, _TAIL, tmp_path_factory.mktemp("emu"))
    so.emu_warm.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    so.emu_warm.restype = ctypes.c_int
    return so


def _emu_warm(so, cache, ka, kb, pair_valid):
    """The kernel source's record [E, 4K, P], from a buffer filled with NaN
    (so a word it does not write shows)."""
    e, p = ka.shape
    prev = torch.full((e, 4 * tp._K, p), float("nan"))
    ops = (ka, kb, pair_valid, cache.key_a, cache.key_b, cache.cand, cache.lam_n,
           cache.lam_1, cache.lam_2)
    assert all(x.is_contiguous() for x in ops)
    assert so.emu_warm(*(x.data_ptr() for x in ops), prev.data_ptr(), e, p,
                       cache.key_a.shape[-1]) == 0
    return prev


@pytest.mark.parametrize("envs,pairs,pairs_old,keys", [
    (e, p, p, ("rows", "uids")[(ie + ip) % 2])
    for ie, e in enumerate((1, 3, 64)) for ip, p in enumerate((128, 256, 2048))
] + [(3, 256, 1100, "uids"), (3, 100, 37, "rows"), (3, 2048, 2048, "uids")])
def test_warm_kernel_source_matches_reference(emulated, envs, pairs, pairs_old, keys):
    """Random caches with hits, misses, empty stored slots, invalid new
    pairs whose keys equal a stored pair's, duplicated stored keys (the
    lowest slot wins) and uids past 2^24, at the pile's P, the sandbox's
    and the big scene's, and a cache of another size than this step's
    slots (more than one tile of stored keys; a ragged last CTA)."""
    cache, ka, kb, pair_valid = torch_planar_emu.warm_case(envs, pairs, keys, pairs_old)
    got = _emu_warm(emulated, cache, ka, kb, pair_valid)
    for e0 in range(0, envs, 8):  # the reference's [E, P, P] match, 8 envs at a time
        part = (tp.map_tensors(lambda x: x[e0:e0 + 8], cache), ka[e0:e0 + 8],
                kb[e0:e0 + 8], pair_valid[e0:e0 + 8])
        want = tp.warm_prev_reference(*part)
        if e0 == 0:
            torch_planar_emu.check_warm_case(*part, want)
        assert torch_planar_emu.warm_bits_equal(got[e0:e0 + 8], want), e0


def test_warm_kernel_source_on_a_pile_rollout(emulated):
    """A cache from a real rollout of the pile (box-only, 64 bodies), keys
    by body index and by uids past 2^24."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(4, 64, "cpu")
    cache = tp.empty_planar_cache(4, 128, device="cpu")
    key_id = (2**24 + 7 * torch.arange(4 * 64, dtype=torch.int32)).reshape(4, 64)
    for kid in (None, key_id):
        bk, ck, _ = fleet.rollout(b, cache, params, 12)
        if kid is not None:
            for _ in range(12):
                bk, ck, _ = tp.step_planar_cached(bk, params, ck, kid)
        bk = tp.planar_integrate_velocities(bk, params.dt, params.gravity)
        ia, ib, pair_valid, _ = tp.planar_broadphase(bk, params.max_pairs)
        ka, kb = tp._pair_keys(ia, ib, pair_valid, kid)
        want = tp.warm_prev_reference(ck, ka, kb, pair_valid)
        assert (want[:, :4] > 0).any()  # some pairs matched
        assert torch_planar_emu.warm_bits_equal(_emu_warm(emulated, ck, ka, kb, pair_valid),
                                                want)


def test_warm_prev_on_the_cpu_takes_the_reference():
    """CPU tensors take warm_prev_reference and launch nothing."""
    case = torch_planar_emu.warm_case(3, 128, "uids")
    before = tp.WARM_KERNEL_LAUNCHES
    assert torch_planar_emu.warm_bits_equal(tp._warm_prev(*case), tp.warm_prev_reference(*case))
    assert tp.WARM_KERNEL_LAUNCHES == before
