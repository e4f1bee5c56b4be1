// Fused per-level point read, one thread per query key.
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
// positives; the wrapper reduces the counters.
//
// Layout: the Pallas kernel bakes the run layout in as constants and
// re-traces for each layout.  Here it is data: one int64 table of 6 rows
// (starts, n_bits, ks, fence_lo, fence_hi, word offsets; rows of R+1) read
// by every thread.  Bloom words are flattened, one run after another, with
// per-run word offsets, not padded to the widest run: a tiered level's
// filters differ in size by up to T times, and padding would multiply their
// memory by that.
//
// Keys: the arenas hold ordered int64 keys (u ^ 2^63), so the binary search
// compares signed; the hash takes the uint64 key back (k ^ 2^63).
//
// What bounds it on the H100: bytes and latency.  A query needs its key (8
// bytes), its outputs (33 bytes), per Bloom-probed run up to k random 8-byte
// word reads, and per positive run log2(run) dependent arena reads plus one
// value read.  Counted as each input read once and each output written once,
// the bytes bound is tiny; in practice the dependent random reads (L2 misses
// into a 100+ MB level) set the time.
//
// The simple design: one thread per key, 256 threads per block, hashes
// recomputed per run (a handful of integer multiplies, cheaper than a local
// array), the Bloom test stops at the first zero bit (the result is the same
// AND), and a run's search runs only for keys that pass its filter and fence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kSign = 0x8000000000000000ULL;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x, uint64_t seed) {
  uint64_t z = x + seed * kGamma;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// layout rows, each R+1 long (per-run rows use the first R entries)
enum { kStarts = 0, kNBits, kKs, kFenceLo, kFenceHi, kWordOff, kRows };

__global__ void point_read_kernel(const long long* __restrict__ q,
                                  long long B,
                                  const long long* __restrict__ ak,
                                  const long long* __restrict__ av,
                                  const long long* __restrict__ layout,
                                  int R,
                                  const long long* __restrict__ words,
                                  unsigned char* __restrict__ hit_out,
                                  long long* __restrict__ enc_out,
                                  long long* __restrict__ probes_out,
                                  long long* __restrict__ reads_out,
                                  long long* __restrict__ fps_out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long* starts = layout + kStarts * (R + 1);
  const long long* n_bits = layout + kNBits * (R + 1);
  const long long* ks = layout + kKs * (R + 1);
  const long long* fence_lo = layout + kFenceLo * (R + 1);
  const long long* fence_hi = layout + kFenceHi * (R + 1);
  const long long* word_off = layout + kWordOff * (R + 1);

  const long long key = q[b];                       // ordered form
  const uint64_t raw = (uint64_t)key ^ kSign;       // the uint64 key
  bool hit = false;
  long long enc = 0, probes = 0, reads = 0, fps = 0;

  for (int r = 0; r < R; ++r) {                     // newest -> oldest
    probes += 1;
    const uint64_t nb = (uint64_t)n_bits[r];
    const long long* wr = words + word_off[r];
    const int k = (int)ks[r];
    bool pos = true;
    for (int j = 0; j < k && pos; ++j) {
      const uint64_t hm = splitmix64(raw, (uint64_t)(j + 1)) % nb;
      const uint64_t w = (uint64_t)wr[hm >> 6];
      pos = (w >> (hm & 63)) & 1ULL;
    }
    if (!pos) continue;
    reads += 1;
    const long long s = starts[r], e = starts[r + 1];
    bool found = false;
    if (e > s && key >= fence_lo[r] && key <= fence_hi[r]) {
      long long lo = s, hi = e;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (ak[mid] < key) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo < e && ak[lo] == key) {
        found = true;
        enc = av[lo];
      }
    }
    if (found) {
      hit = true;
      break;                                        // no longer live
    }
    fps += 1;
  }
  hit_out[b] = hit ? 1 : 0;
  enc_out[b] = enc;
  probes_out[b] = probes;
  reads_out[b] = reads;
  fps_out[b] = fps;
}

}  // namespace

extern "C" int point_read_launch(const long long* q, long long B,
                                 const long long* ak, const long long* av,
                                 const long long* layout, int R,
                                 const long long* words,
                                 unsigned char* hit, long long* enc,
                                 long long* probes, long long* reads,
                                 long long* fps, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  point_read_kernel<<<blocks, threads, 0, stream>>>(
      q, B, ak, av, layout, R, words, hit, enc, probes, reads, fps);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
