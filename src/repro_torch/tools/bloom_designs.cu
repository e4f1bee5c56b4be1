// Designs of the blocked-Bloom probe that csrc/bloom_probe.cu does not ship,
// for tools/bloom_designs.py to time against it.  Same function, same
// stop at a key's first zero bit; one design a build, chosen by -D flags:
//
//   KPT          keys a thread (key t of a thread is base + t * kThreads,
//                coalesced), whose loads of a round issue together
//   FIRST        plane floats a key reads in its first round
//   STEP         ... in each later round, at most
//   EVICT_FIRST  1: the plane's loads carry an evict-first L2 policy
//
// KPT=1 FIRST=1 STEP=1 EVICT_FIRST=0 is the shipped design's order of
// loads.  Each key's count of plane floats read goes to `loads`.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(KPT) || !defined(FIRST) || !defined(STEP) || \
    !defined(EVICT_FIRST)
#error "build with -DKPT=.. -DFIRST=.. -DSTEP=.. -DEVICT_FIRST=.."
#endif

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x += seed * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float load_plane(const float* p, uint64_t pol) {
  if (!EVICT_FIRST) return __ldg(p);
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// One round of loads: up to G floats of each live key from bit j on,
// issued together, then multiplied in j order.
template <int G>
__device__ __forceinline__ void round_of(const uint32_t (&key)[KPT],
                                         const float* const (&row)[KPT],
                                         float (&m)[KPT], int (&cnt)[KPT],
                                         int j, int k, uint32_t block_bits,
                                         uint64_t pol) {
  float v[KPT][G];
#pragma unroll
  for (int t = 0; t < KPT; ++t) {
    const bool live = m[t] != 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[t][g] = 1.0f;
      if (live && j + g < k) {
        v[t][g] = load_plane(
            row[t] + mix32(key[t], (uint32_t)(j + g + 2)) % block_bits, pol);
        ++cnt[t];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < KPT; ++t) {
#pragma unroll
    for (int g = 0; g < G; ++g) m[t] *= v[t][g];
  }
}

__global__ void __launch_bounds__(kThreads) bloom_design_kernel(
    const long long* __restrict__ keys, long long n,
    const float* __restrict__ plane, uint32_t num_blocks,
    uint32_t block_bits, int k, float* __restrict__ out,
    int* __restrict__ loads) {
  const long long base =
      (long long)blockIdx.x * (kThreads * KPT) + threadIdx.x;
  uint64_t pol = 0;
  if (EVICT_FIRST)
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  uint32_t key[KPT];
  const float* row[KPT];
  float m[KPT];
  int cnt[KPT];
#pragma unroll
  for (int t = 0; t < KPT; ++t) {
    const long long i = base + (long long)t * kThreads;
    key[t] = i < n ? (uint32_t)__ldg(keys + i) : 0u;
    row[t] = plane + (uint64_t)(mix32(key[t], 1u) % num_blocks) * block_bits;
    m[t] = i < n ? 1.0f : 0.0f;
    cnt[t] = 0;
  }
  round_of<FIRST>(key, row, m, cnt, 0, k, block_bits, pol);
  for (int j = FIRST; j < k; j += STEP) {
    bool live = false;
#pragma unroll
    for (int t = 0; t < KPT; ++t) live |= m[t] != 0.0f;
    if (!live) break;
    round_of<STEP>(key, row, m, cnt, j, k, block_bits, pol);
  }
#pragma unroll
  for (int t = 0; t < KPT; ++t) {
    const long long i = base + (long long)t * kThreads;
    if (i < n) {
      __stcs(out + i, m[t]);
      loads[i] = cnt[t];
    }
  }
}

}  // namespace

extern "C" int bloom_design_launch(const long long* keys, long long n,
                                   const float* plane, long long num_blocks,
                                   long long block_bits, int k, float* out,
                                   int* loads, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long per_block = (long long)kThreads * KPT;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  bloom_design_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, n, plane, (uint32_t)num_blocks, (uint32_t)block_bits, k, out,
      loads);
  return (int)cudaGetLastError();
}
