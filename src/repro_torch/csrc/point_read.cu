// Fused per-level point read, redesigned for Hopper: one thread a key,
// hashes computed once, an exact reciprocal modulo, and a search through a
// per-run key sample.
//
// Replaces: src/repro/kernels/point_read/kernel.py:115 point_read_level_kernel
// (the Pallas tile body _point_read_tile at :39).
//
// A key batch against every run of one level, newest run to oldest, with the
// engine's sequential-equivalent per-key counters:
//   probes += live;  Bloom test (k splitmix64 rounds mod n_bits[r]);
//   reads += pos;    fence window + lower-bound search in [starts[r],
//                    starts[r+1]);  fps += pos & !found.
// A key found in a newer run stops being live and is neither probed nor read
// in older ones.  Outputs per key: hit, encoded value, probes, reads, false
// positives; the wrapper's caller reduces the counters.
//
// Layout: one int64 table of kRows rows of R+1 (per-run rows use the first
// R): run starts, n_bits, k, fence keys, Bloom word offsets, the modulo's
// reciprocal, sample and top offsets, top levels.  Bloom words, samples and
// tops are flat, one run after another.  Arena keys are ordered int64
// (u ^ 2^63), so searches compare signed; the hash takes the uint64 back.
//
// What bounds it on the H100: each key's chain of dependent reads, and the
// L2's and DRAM's random sectors.  The bytes the function must move (a key
// in, 33 bytes out, a Bloom word per probe, a key and a value per positive
// run) take 0.017 ms for 1 M keys; the parent design, a plain binary search,
// spent ~47,000 cycles a positive key against the 10 M-entry tree's deepest
// level (8.06 M entries, 64.5 MB of keys, above the 50 MB L2;
// tools/point_read_probe.py): 22,600 in the search's last 11 halvings (DRAM),
// 9,300 hashing and testing the filter, 7,200 in the first 12 halvings (L2),
// 2,600 on the value.  The design:
//
// * Hashes once per key: a splitmix64 round is computed when a run first
//   needs it and, on a level of several runs, kept in registers for the
//   later runs, under the template bound KMAX (4, 8, 16 or 32; the wrapper
//   picks the least that holds the level's largest k and refuses a level
//   above 32).  The test stops at the first zero bit (the same AND; a key the
//   filter drops mostly stops after one word).
// * An exact reciprocal modulo: h mod n = h - umulhi(h, M) n, less n once
//   more if that is >= n, with M = floor((2^64 - 1) / n) from the table
//   (umulhi(h, M) is the quotient or one less; utils/u64.py proves it).
// * A sampled search.  A run of at least S_min entries (kernels/point_read/
//   ops.py) has a sample: level 1 every kStride-th key, each later level
//   every kFanout-th entry of the one below, up to a top level of at most
//   the run's share of kTopCap entries (built on the device with the Bloom
//   words, lsm/store.py).  Each block loads the level's table and tops into
//   shared memory once, then loops over keys.  A key's lower bound: the top
//   level bisected in shared memory, then one node (kFanout entries, one
//   32-byte sector) a level down the sample in the L2 (a deep run's sample
//   fits there beside its filter), then the kStride arena keys after the
//   level-1 entry below the key, read in one round of 16-byte pair loads,
//   then the value: two DRAM rounds where the plain search took ~11.
//   Shorter runs keep the plain lower-bound loop.  A sorted unique run has
//   one lower bound, so the outputs are those of the plain search bit for
//   bit.  The filters and the sample are read with an L2 policy that keeps
//   them (evict_last), the windows and values with one that lets them go.
// * Blocks of 256 threads; the grid is the batch's blocks, capped at what
//   the card holds at once, so a small batch loads the tops few times.
//
// Per positive key it now spends ~20,200 cycles (probe): 5,700 down the
// sample, 5,100 on the filter, 3,000 on the window, 2,500 on the value,
// 1,400 in the top.  Batches of tiles that search only the filter's
// positives (a block queue, a warp queue), reading windows and nodes by a
// warp together, larger blocks with larger tops and loading a run's k words
// together each measured slower on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kSign = 0x8000000000000000ULL;
constexpr int kThreads = 256;
constexpr int kStride = 8;       // level 1 keeps every kStride-th key
constexpr int kFanout = 4;       // a later level every kFanout-th entry
constexpr int kTopCap = 4096;    // top entries of a level, 32 KB
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x, uint64_t seed) {
  uint64_t z = x + seed * kGamma;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// x mod n for 1 <= n < 2^62, m = floor((2^64 - 1) / n)
__device__ __forceinline__ uint64_t mod_magic(uint64_t x, uint64_t n,
                                              uint64_t m) {
  const uint64_t r = x - __umul64hi(x, m) * n;
  return r >= n ? r - n : r;
}

// L2 policies: the filters and the samples, read again by later keys, stay
// (evict_last); the arena's windows and values, read once, go first
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  } else {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  }
  return p;
}

__device__ __forceinline__ long long load(const long long* p, uint64_t pol) {
  long long v;
  asm volatile("ld.global.nc.L2::cache_hint.b64 %0, [%1], %2;"
               : "=l"(v) : "l"(p), "l"(pol));
  return v;
}

// The number of the kFanout entries of a node (one 32-byte sector, 16-byte
// aligned) below key
__device__ __forceinline__ int node_below(const long long* p, long long key,
                                          uint64_t pol) {
  int below = 0;
#pragma unroll
  for (int i = 0; i < kFanout; i += 2) {
    long long a, b;
    asm volatile("ld.global.nc.L2::cache_hint.v2.b64 {%0, %1}, [%2], %3;"
                 : "=l"(a), "=l"(b) : "l"(p + i), "l"(pol));
    below += (a < key) + (b < key);
  }
  return below;
}

// layout rows, each R+1 long (per-run rows use the first R entries)
enum {
  kStarts = 0, kNBits, kKs, kFenceLo, kFenceHi, kWordOff, kMagic,
  kSampleOff, kTopOff, kTopLevel, kRows
};

struct Level {                   // the layout table, in shared memory
  const long long *starts, *n_bits, *ks, *fence_lo, *fence_hi, *word_off,
      *magic, *sample_off, *top_off, *top_level, *top;
};

// Loads the table and the tops into shared memory (the caller syncs); the
// tops start 16-byte aligned.
__device__ __forceinline__ Level load_level(long long* smem,
                                            const long long* layout, int R,
                                            const long long* top,
                                            int top_total) {
  const int rows = R + 1, table = (kRows * rows + 1) & ~1;
  for (int i = threadIdx.x; i < kRows * rows; i += kThreads)
    smem[i] = layout[i];
  long long* s_top = smem + table;
  for (int i = threadIdx.x; i < top_total; i += kThreads) s_top[i] = top[i];
  return {smem + kStarts * rows,   smem + kNBits * rows,
          smem + kKs * rows,       smem + kFenceLo * rows,
          smem + kFenceHi * rows,  smem + kWordOff * rows,
          smem + kMagic * rows,    smem + kSampleOff * rows,
          smem + kTopOff * rows,   smem + kTopLevel * rows, s_top};
}

// entries of sample level l (padded to whole nodes) of a run of n entries:
// ceil(n / (kStride kFanout^(l-1))), rounded up to a multiple of kFanout
__device__ __forceinline__ long long level_size(long long n, int l) {
  const int shift = 3 + 2 * (l - 1);             // kStride 8, kFanout 4
  const long long m = (n + (1LL << shift) - 1) >> shift;
  return (m + kFanout - 1) & ~(long long)(kFanout - 1);
}

// Run r's Bloom test for the uint64 key raw, stopping at the first zero
// bit (the same AND; a key the filter drops mostly stops after one word).
// With ONE_RUN each round is computed here, once; otherwise rounds
// 1..have are kept in h for the level's later runs.
template <int KMAX, bool ONE_RUN>
__device__ __forceinline__ bool bloom_test(uint64_t raw, const Level& lv,
                                           int r,
                                           const long long* __restrict__ words,
                                           uint64_t* h, int& have,
                                           uint64_t keep) {
  const int k = (int)lv.ks[r];
  const uint64_t nb = (uint64_t)lv.n_bits[r], mg = (uint64_t)lv.magic[r];
  const long long* wr = words + lv.word_off[r];
  bool pos = true;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k && pos) {
      uint64_t hj;
      if constexpr (ONE_RUN) {
        hj = splitmix64(raw, (uint64_t)(j + 1));
      } else {
        if (j >= have) {
          h[j] = splitmix64(raw, (uint64_t)(j + 1));
          have = j + 1;
        }
        hj = h[j];
      }
      const uint64_t hm = mod_magic(hj, nb, mg);
      pos = ((uint64_t)load(wr + (hm >> 6), keep) >> (hm & 63)) & 1ULL;
    }
  }
  return pos;
}

// Run r's lower bound for a key within its fence: whether the run holds
// the key, and where (lo).  A run with a sample: the count c of level-1
// entries below the key, from the top level f bisected in shared memory,
// then down levels f-1..1 in the L2 (at level l the node under the
// level-(l+1) count c starts at kFanout (c - 1), and a count of 0 stays
// 0), each node one sector read as 16-byte pairs; then the kStride arena
// keys after
// level-1 entry c - 1, read in one round of independent pair loads.  A
// short run: the plain lower-bound loop.
__device__ __forceinline__ bool search_run(long long key, const Level& lv,
                                           int r,
                                           const long long* __restrict__ ak,
                                           const long long* __restrict__ sample,
                                           uint64_t keep, uint64_t once,
                                           long long& lo) {
  const long long s = lv.starts[r], e = lv.starts[r + 1], n = e - s;
  const int f = (int)lv.top_level[r];
  if (f == 0) {                                  // a short run
    lo = s;
    long long hi = e;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(ak + mid) < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo < e && __ldg(ak + lo) == key;
  }
  const long long* tp = lv.top + lv.top_off[r];
  int t = 0, tn = (int)(lv.top_off[r + 1] - lv.top_off[r]);
  while (tn > 0) {                               // t = #{top < key}
    const int half = tn >> 1;
    const bool less = tp[t + half] < key;
    t = less ? t + half + 1 : t;
    tn = less ? tn - half - 1 : half;
  }
  long long c = t, off = 0;                      // off: level f-1's start
  for (int i = 1; i < f - 1; ++i) off += level_size(n, i);
  const long long* levels = sample + lv.sample_off[r];
  for (int l = f - 1; l >= 1 && c > 0; --l) {
    const long long start = kFanout * (c - 1);
    c = start + node_below(levels + off + start, key, keep);
    if (l > 1) off -= level_size(n, l - 1);
  }
  // the lower bound lies in the kStride keys after level-1 entry c - 1
  // (key (c - 1) kStride of the run), the last of them entry c; with c = 0
  // it is the run's first key.  They are read as the 16-byte pairs that
  // cover them (the run may start at any 8-byte offset), a pair with a
  // place outside the window as one word.
  const long long base = c == 0 ? 0 : (c - 1) * kStride + 1;
  const long long len = n - base;
  const long long* wp = ak + s + base;
  const long long* a0 = (const long long*)((uintptr_t)wp & ~(uintptr_t)15);
  const int sh = (int)(wp - a0);                 // 0 or 1
  long long w[kStride + 2];
#pragma unroll
  for (int j = 0; j < kStride + 2; j += 2) {
    const int i0 = j - sh, i1 = j + 1 - sh;      // the pair's window places
    if (i0 >= 0 && i1 < len) {
      asm volatile("ld.global.nc.L2::cache_hint.v2.b64 {%0, %1}, [%2], %3;"
                   : "=l"(w[j]), "=l"(w[j + 1]) : "l"(a0 + j), "l"(once));
    } else if (i0 < 0 && i1 < len) {             // the pair's first is not ours
      w[j + 1] = load(wp, once);
    } else if (i0 >= 0 && i0 < len) {            // nor its second
      w[j] = load(wp + i0, once);
    }
  }
  int below = 0;
  bool found = false;
#pragma unroll
  for (int j = 0; j < kStride + 2; ++j) {
    const int i = j - sh;
    if (i >= 0 && i < kStride && i < len) {
      below += w[j] < key;
      found = found || w[j] == key;
    }
  }
  lo = s + base + below;
  return found;
}

struct Out {
  unsigned char* hit;
  long long *enc, *probes, *reads, *fps;
};

// One thread a key through the level's runs, newest to oldest; blocks
// loop over the batch.  KMAX bounds the level's k; ONE_RUN levels keep no
// rounds (no later run reads them), so the search holds fewer registers.
template <int KMAX, bool ONE_RUN>
__global__ void __launch_bounds__(kThreads) point_read_kernel(
    const long long* __restrict__ q, int B,
    const long long* __restrict__ ak, const long long* __restrict__ av,
    const long long* __restrict__ layout, int R,
    const long long* __restrict__ words,
    const long long* __restrict__ sample,
    const long long* __restrict__ top, int top_total, Out out) {
  extern __shared__ long long smem[];
  const Level lv = load_level(smem, layout, R, top, top_total);
  __syncthreads();
  const uint64_t keep = l2_policy(true), once = l2_policy(false);
  const int step = gridDim.x * kThreads;         // B < 2^30 (the entry)
  int b = blockIdx.x * kThreads + threadIdx.x;
  long long next = b < B ? q[b] : 0;
  for (; b < B; b += step) {
    const long long key = next;                  // ordered form
    if (b + step < B) next = q[b + step];        // the next key, early
    const uint64_t raw = (uint64_t)key ^ kSign;  // the uint64 key
    uint64_t h[ONE_RUN ? 1 : KMAX];              // rounds 1..have
    int have = 0, probes = 0, reads = 0, fps = 0;
    bool hit = false;
    long long enc = 0;
    for (int r = 0; r < (ONE_RUN ? 1 : R); ++r) {  // newest -> oldest
      probes += 1;
      if (!bloom_test<KMAX, ONE_RUN>(raw, lv, r, words, h, have, keep))
        continue;
      reads += 1;
      long long lo;
      if (lv.starts[r + 1] > lv.starts[r] && key >= lv.fence_lo[r] &&
          key <= lv.fence_hi[r] &&
          search_run(key, lv, r, ak, sample, keep, once, lo)) {
        hit = true;
        enc = load(av + lo, once);
        break;                                   // no longer live
      }
      fps += 1;
    }
    out.hit[b] = hit ? 1 : 0;
    out.enc[b] = enc;
    out.probes[b] = probes;
    out.reads[b] = reads;
    out.fps[b] = fps;
  }
}

// The grid: the batch's blocks, capped at what the card holds at once.
template <int KMAX, bool ONE_RUN>
int launch(const long long* q, int B, const long long* ak,
           const long long* av, const long long* layout, int R,
           const long long* words, const long long* sample,
           const long long* top, int top_total, Out out,
           cudaStream_t stream) {
  auto kernel = point_read_kernel<KMAX, ONE_RUN>;
  const int smem =
      (((kRows * (R + 1) + 1) & ~1) + top_total) * (int)sizeof(long long);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int need = (B + kThreads - 1) / kThreads;
  const int most = (per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<need < most ? need : most, kThreads, smem, stream>>>(
      q, B, ak, av, layout, R, words, sample, top, top_total, out);
  return (int)cudaGetLastError();
}

template <int KMAX>
int launch_k(const long long* q, int B, const long long* ak,
             const long long* av, const long long* layout, int R,
             const long long* words, const long long* sample,
             const long long* top, int top_total, Out out,
             cudaStream_t stream) {
  return R == 1 ? launch<KMAX, true>(q, B, ak, av, layout, R, words, sample,
                                     top, top_total, out, stream)
                : launch<KMAX, false>(q, B, ak, av, layout, R, words,
                                      sample, top, top_total, out, stream);
}

}  // namespace

extern "C" int point_read_launch(const long long* q, long long B,
                                 const long long* ak, const long long* av,
                                 const long long* layout, int R,
                                 const long long* words,
                                 const long long* sample,
                                 const long long* top, int top_total,
                                 int kmax, unsigned char* hit,
                                 long long* enc, long long* probes,
                                 long long* reads, long long* fps,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B >= (1LL << 30) || top_total < 0 || top_total > kTopCap)
    return (int)cudaErrorInvalidValue;
  const Out out{hit, enc, probes, reads, fps};
  const int b = (int)B;
  if (kmax <= 4)
    return launch_k<4>(q, b, ak, av, layout, R, words, sample, top,
                       top_total, out, stream);
  if (kmax <= 8)
    return launch_k<8>(q, b, ak, av, layout, R, words, sample, top,
                       top_total, out, stream);
  if (kmax <= 16)
    return launch_k<16>(q, b, ak, av, layout, R, words, sample, top,
                        top_total, out, stream);
  if (kmax <= 32)
    return launch_k<32>(q, b, ak, av, layout, R, words, sample, top,
                        top_total, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
