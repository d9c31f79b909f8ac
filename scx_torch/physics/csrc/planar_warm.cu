// The warm-start key match of the planar physics step, for Hopper (sm_90a).
//
// planar_warm_match_kernel is scx_torch.physics.planar._warm_prev on the
// card: each of this step's pairs finds its pair of the previous step by
// key and takes that pair's stored record.
//   in : ka, kb [E,P] i32 this step's keys, pv [E,P] bool pair-valid;
//        key_a, key_b [E,P_old] i32 the cache's keys (-1: empty slot),
//        cand [E,K,P_old] i32, lam_n, lam_1, lam_2 [E,K,P_old] f32
//   out: prev [E,4K,P] f32: rows 0:K cand + 1, then K rows each of lam_n,
//        lam_1, lam_2; zeros where the pair has no match
// Slot i matches stored slot j when pv[i], ka[i] == key_a[j], kb[i] ==
// key_b[j] and key_a[j] != -1; of several such j the lowest wins (the
// argmax of the first True in warmstart.key_match). Bit for bit the plain
// version, planar.warm_prev_reference.
//
// It replaces no pallas_call: scx matches keys with a one-hot [P, P]
// matmul that it leaves to XLA, which the plain version carries over as
// [E, P, P] compares, an argmax and a gather (~3 GB of device traffic at
// 16,384 x 128). The match is a selection, bound by its bytes: the keys
// and pair-valid flags (9 B a slot), the stored keys (8 B), the records
// of the matched slots (64 B) and prev (64 B a slot): 0.09 ms at 16,384 x
// 128 at 3.35 TB/s. What the design does about that:
//   - one thread per new slot, WARM_THREADS slots per CTA, and P / 128
//     CTAs per env (rounded up), so the grid follows E and P (16,384 CTAs
//     at the pile's 16,384 x 128, 64 at the big scene's 4 x 2,048);
//   - the CTA stages its env's stored keys in shared memory, a 64-bit
//     word per slot, WARM_TILE slots at a time, so every slot's keys are
//     read from device memory once per CTA and no P is too large;
//   - each thread scans the stored words in order from slot 0 and stops
//     at the first equal one: every lane of a warp reads the same word (a
//     broadcast), a thread with no pair-valid key scans nothing. At P =
//     128 that is at most 128 compares a slot, well under the bytes;
//   - each thread gathers its match's 4K words from the env's stored rows
//     (P_old-minor, so neighbouring threads mostly read neighbouring words:
//     pairs keep their order from step to step) and writes its column of
//     prev, each row coalesced over the CTA's slots.
// Built with the other kernels into one library (scx_torch/_build.py).

#include "planar_device.cuh"

namespace {

constexpr int WARM_THREADS = 128;  // new slots per CTA
constexpr int WARM_TILE = 1024;    // stored keys in shared memory at a time (8 KB)
constexpr int EMPTY_KEY = -1;

__device__ __forceinline__ unsigned long long key_word(int a, int b) {
  return (unsigned long long)(unsigned)a << 32 | (unsigned)b;
}

__global__ void __launch_bounds__(WARM_THREADS) planar_warm_match_kernel(
    const int* __restrict__ ka, const int* __restrict__ kb, const unsigned char* __restrict__ pv,
    const int* __restrict__ key_a, const int* __restrict__ key_b, const int* __restrict__ cand,
    const float* __restrict__ lam_n, const float* __restrict__ lam_1,
    const float* __restrict__ lam_2, float* __restrict__ prev, int np, int np_old,
    int chunks) {
  extern __shared__ float smem_words[];
  unsigned long long* stored = (unsigned long long*)smem_words;  // [WARM_TILE]
  const long long e = blockIdx.x / chunks;
  const int i = (int)(blockIdx.x % chunks) * WARM_THREADS + threadIdx.x;
  const size_t slot = (size_t)e * np + i;
  // A pair with key_a -1 equals only empty stored slots, which never match.
  const bool live = i < np && pv[slot] && ka[slot] != EMPTY_KEY;
  const unsigned long long mine = live ? key_word(ka[slot], kb[slot]) : 0;
  int hit = -1;
  for (int t0 = 0; t0 < np_old; t0 += WARM_TILE) {
    const int n = min(WARM_TILE, np_old - t0);
    __syncthreads();  // the last tile is read
    for (int j = threadIdx.x; j < n; j += WARM_THREADS) {
      const size_t s = (size_t)e * np_old + t0 + j;
      stored[j] = key_word(ldg(key_a + s), ldg(key_b + s));
    }
    __syncthreads();
    if (live && hit < 0) {
      for (int j = 0; j < n; ++j) {
        if (stored[j] == mine) {
          hit = t0 + j;
          break;
        }
      }
    }
  }
  if (i >= np) return;
  float* out = prev + (size_t)e * 4 * K * np + i;
  if (hit < 0) {
#pragma unroll
    for (int r = 0; r < 4 * K; ++r) out[(size_t)r * np] = 0.f;
    return;
  }
  const size_t src = (size_t)e * K * np_old + hit;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t s = src + (size_t)k * np_old;
    // cand + 1 in int32 arithmetic, as torch adds, then rounded to float
    out[(size_t)k * np] = (float)(int)((unsigned)ldg(cand + s) + 1u);
    out[(size_t)(K + k) * np] = ldg(lam_n + s);
    out[(size_t)(2 * K + k) * np] = ldg(lam_1 + s);
    out[(size_t)(3 * K + k) * np] = ldg(lam_2 + s);
  }
}

size_t warm_smem_bytes() { return sizeof(unsigned long long) * WARM_TILE; }

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ------------
// Everything above this line is also built with g++ for a CPU run of the
// kernel (tests/test_torch_warm_emulated.py): keep it free of CUDA
// intrinsics that the test's shim does not define.

extern "C" {

// prev: E 4K P words. Launches on `device`, made current for the launch if
// it is not.
int scx_planar_warm(const void* ka, const void* kb, const void* pv, const void* key_a,
                    const void* key_b, const void* cand, const void* lam_n, const void* lam_1,
                    const void* lam_2, void* prev, int e, int p, int p_old, int device,
                    void* stream) {
  if ((long long)e * p == 0) return 0;
  const int chunks = (p + WARM_THREADS - 1) / WARM_THREADS;
  const long long blocks = (long long)e * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  planar_warm_match_kernel<<<(unsigned)blocks, WARM_THREADS, warm_smem_bytes(),
                             (cudaStream_t)stream>>>(
      (const int*)ka, (const int*)kb, (const unsigned char*)pv, (const int*)key_a,
      (const int*)key_b, (const int*)cand, (const float*)lam_n, (const float*)lam_1,
      (const float*)lam_2, (float*)prev, p, p_old, chunks);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
