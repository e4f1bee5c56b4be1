// Stable two-way merge-path merge, one thread per output position.
//
// Replaces: src/repro/kernels/merge/kernel.py:70 two_way_merge_kernel
// (the Pallas tile body _merge_tile at :33).
//
// Run A is newer than run B; both are sorted.  Output position m takes the
// merge-path split i (how many of the first m outputs come from A): the
// smallest i in [max(0, m - nB), min(m, nA)] with B[m-i-1] < A[i], found by
// binary search on the diagonal with the Pallas kernel's rule
// take_more_a = !(B[m-i-1] < A[i]).  The output is then one gather from A or
// B; on equal keys A comes first, so the caller's adjacent-duplicate drop
// keeps the newest version.  Keys are the engine's ordered int64 form
// (u ^ 2^63), so signed compares are unsigned key order.  Indices are 64-bit.
//
// What bounds it on the H100: bytes.  The merge must read A and B (keys and
// values, 16 bytes per entry) and write nA + nB entries: 32 bytes per output,
// ~10 us per million outputs at 3.35 TB/s.  The binary search adds
// log2(nA + nB) dependent key reads per thread; they hit L2 for the upper
// levels of the search, but the last few are scattered reads to DRAM.
//
// The simple design: every thread searches independently (no per-block
// co-rank and no shared-memory staging), 256 threads per block.  Neighbouring
// threads search neighbouring diagonals, so their probes share cache lines and
// the final gathers are contiguous.

#include <cuda_runtime.h>

namespace {

__global__ void merge_path_kernel(const long long* __restrict__ ak,
                                  const long long* __restrict__ av,
                                  long long na,
                                  const long long* __restrict__ bk,
                                  const long long* __restrict__ bv,
                                  long long nb, long long* __restrict__ ok,
                                  long long* __restrict__ ov) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= na + nb) return;
  long long lo = m > nb ? m - nb : 0;
  long long hi = m < na ? m : na;
  while (lo < hi) {
    const long long i = (lo + hi) >> 1;
    // B[m-i-1] >= A[i]: too few taken from A
    if (!(bk[m - i - 1] < ak[i])) {
      lo = i + 1;
    } else {
      hi = i;
    }
  }
  const long long i = lo;
  const long long j = m - i;
  const bool take_a = i < na && (j >= nb || ak[i] <= bk[j]);
  if (take_a) {
    ok[m] = ak[i];
    ov[m] = av[i];
  } else {
    ok[m] = bk[j];
    ov[m] = bv[j];
  }
}

}  // namespace

extern "C" int merge_launch(const long long* ak, const long long* av,
                            long long na, const long long* bk,
                            const long long* bv, long long nb, long long* ok,
                            long long* ov, cudaStream_t stream) {
  const long long n = na + nb;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  merge_path_kernel<<<blocks, threads, 0, stream>>>(ak, av, na, bk, bv, nb,
                                                    ok, ov);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
