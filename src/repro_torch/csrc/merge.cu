// The compaction merge: a tiled merge-path merge of two sorted runs, with
// the newest-wins drop of adjacent duplicate keys fused in.
//
// Replaces: src/repro/kernels/merge/kernel.py:70 two_way_merge_kernel
// (the Pallas tile body _merge_tile at :33), and the adjacent-duplicate
// drop that follows each of its calls in a fold step
// (src/repro/kernels/merge/ops.py:26 _dedup).
//
// Run A is newer than run B; both are sorted, keys in the engine's ordered
// int64 form (u ^ 2^63), so signed compares are unsigned key order.  The
// merge is stable, A first on equal keys: the split of diagonal d (how many
// of the first d outputs come from A) is the smallest i with
// B[d-i-1] < A[i], the Pallas kernel's rule.  With the drop, output m is
// kept iff its key differs from output m-1's, so of equal keys the first,
// A's (the newest), survives.  Indices are 64-bit.
//
// What bounds it on the H100: bytes.  A step must read both runs (key and
// value, 16 bytes an entry) and write the kept entries (16 bytes each);
// at 5 M + 5 M with 8.44 M kept that is 0.088 ms at 3.35 TB/s.  The design
// reads and writes each byte once, in three stages over two launches:
//
// 1. lsm_merge_partition: a group of lanes per tile boundary d = t * TILE
//    (t = 0..ntiles) searches the split on its diagonal in device memory,
//    one probe a lane each round (a ways-ary search: ~log_ways(n)
//    dependent rounds where a binary search takes ~log2(n) dependent
//    reads; 32 ways while there are few boundaries, 8 from 1,024 tiles,
//    where the reads of so many would bound it).  Doing them all in one
//    small launch keeps that latency off the tiles.  It also clears the
//    tiles' status words and the tile counter.
// 2. lsm_merge_tile<DROP>: one block of THREADS per tile of TILE outputs.
//    It loads the tile's windows of A and B (keys and values) into shared
//    memory with 8-byte loads, each warp's 32 on one 256-byte-aligned span
//    whatever the offset of a run's view.  Each thread finds its own split
//    at diagonal tid * K of the tile with a short shared-memory search and
//    emits its K outputs serially into registers, with keep flags: an
//    output's predecessor is the thread's previous output, for the first
//    the larger of the last A and the last B before its split (in shared
//    memory, or for the tile's first output in device memory), so a
//    duplicate pair that straddles two threads or two tiles drops B's copy.
// 3. Compaction in the same launch: a block scan of the kept counts gives
//    each thread's offset in the tile; the tile's global offset comes from
//    a decoupled look-back: each tile publishes its kept count, then its
//    inclusive prefix, in one 64-bit status word, which warp 0 of later
//    tiles reads 32 at a time.  A block takes its tile from a counter (one
//    atomic add), so a tile waits only on tiles that blocks already running
//    hold, and the wait ends whatever order the hardware starts blocks in.
//    The kept entries are staged in
//    shared memory and written out, each warp's 32 stores on one
//    256-byte-aligned span.  The last tile writes the total, which the
//    wrapper reads back to size the output: one device-to-host copy a
//    step.
//
// Without the drop (DROP = false: two_way_merge, the interleave with
// duplicates) a tile's offset is its first diagonal and no look-back runs.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int K = 8;                  // outputs per thread
constexpr int TILE = THREADS * K;     // outputs per block
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_BYTES = (2 * TILE + 1) * 8;   // a tile's windows

constexpr long long KEY_MIN = -0x7fffffffffffffffLL - 1;

// status word of a tile: the flag in the top two bits, a count below
constexpr unsigned long long FLAG_COUNT = 1ull << 62;   // its kept count
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;  // its inclusive prefix
constexpr unsigned long long VALUE_MASK = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The kept count of the tiles before tile t > 0, by one warp: 32 status
// words a round, nearest first, summed back to the nearest tile that holds
// its inclusive prefix, waiting on those nearer that have published
// nothing yet.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, long long t, int lane) {
  long long base = 0;
  for (long long top = t - 1;; top -= 32) {
    const long long idx = top - lane;
    unsigned long long st = idx >= 0 ? load_status(status + idx)
                                     : FLAG_PREFIX;  // before tile 0: 0
    // wait only on the tiles nearer than the nearest prefix
    unsigned pre, open;
    while (true) {
      pre = __ballot_sync(0xffffffffu, (st >> 62) == 2);
      open = __ballot_sync(0xffffffffu, (st >> 62) == 0);
      const unsigned need = pre ? open & ((pre & -pre) - 1) : open;
      if (!need) break;
      if ((need >> lane) & 1u) st = load_status(status + idx);
    }
    const int stop = pre ? __ffs(pre) - 1 : 31;
    long long v = lane <= stop ? (long long)(st & VALUE_MASK) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    base += v;
    if (pre) return base;
  }
}

__global__ void lsm_merge_partition(const long long* __restrict__ ak,
                                    long long na,
                                    const long long* __restrict__ bk,
                                    long long nb, long long ntiles, int lg,
                                    long long* __restrict__ splits,
                                    unsigned long long* __restrict__ status,
                                    unsigned long long* __restrict__ ticket) {
  // a group of ways = 2^lg lanes per boundary, 32 / ways boundaries a warp
  const int ways = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int g = lane >> lg, gl = lane & (ways - 1);
  const long long t =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5 << (5 - lg)) +
      g;
  const bool active = t <= ntiles;
  if (active && gl == 0 && t < ntiles) status[t] = 0;
  if (t == 0 && gl == 0) *ticket = 0;
  const long long n = na + nb;
  const long long d = !active ? 0 : t * TILE < n ? t * TILE : n;
  // the smallest i in [lo, hi) with B[d-i-1] < A[i], else hi; each round
  // the group's lanes probe evenly spaced i and keep the segment where
  // the test turns true (it is false, then true, along the diagonal)
  long long lo = !active ? 0 : d > nb ? d - nb : 0;
  long long hi = !active ? 0 : d < na ? d : na;
  const unsigned mask = ways == 32 ? 0xffffffffu : (1u << ways) - 1;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const bool open = lo < hi;
    const long long step = open ? (hi - lo + ways - 1) >> lg : 1;
    const long long p = lo + gl * step;
    const bool right = open && p < hi && bk[d - p - 1] < ak[p];
    const unsigned m = (__ballot_sync(0xffffffffu, right) >> (g << lg)) & mask;
    if (open) {
      if (m) {
        const int f = __ffs(m) - 1;
        const long long top = lo + f * step;
        lo = f ? top - step + 1 : top;
        hi = top;
      } else {
        lo += (hi - 1 - lo) / step * step + 1;  // past the last probe
      }
    }
  }
  if (active && gl == 0) splits[t] = lo;
}

// The window of tile t: outputs [d0, d0 + len) take A[i0, i0 + la) and
// B[j0, j0 + lb).
struct Tile {
  long long t, d0, i0, j0;
  int la, lb, len;
};

__device__ __forceinline__ Tile tile_of(long long t, long long lo,
                                        long long hi, long long n) {
  Tile w;
  w.t = t;
  w.d0 = t * TILE;
  w.len = (int)((n - w.d0) < TILE ? n - w.d0 : TILE);
  w.i0 = lo;
  w.j0 = w.d0 - lo;
  w.la = (int)(hi - lo);
  w.lb = w.len - w.la;
  return w;
}

// Merge, keep flags, scan and the coalesced store of one tile whose
// windows are in sk (keys: A then B, one spare slot) and sv.  The THREADS
// merging threads call it; it ends after the stores are issued.
template <bool DROP>
__device__ __forceinline__ void tile_body(
    long long* sk, long long* sv, const Tile& w, long long tile_pred,
    bool tile_has_pred, unsigned long long* status, long long* total,
    long long ntiles, long long* __restrict__ ok,
    long long* __restrict__ ov, int* s_scan, long long* s_base) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int la = w.la, lb = w.lb, len = w.len;

  // this thread's split at tile diagonal tid * K
  const long long* sa = sk;
  const long long* sb = sk + la;
  const int diag = tid * K < len ? tid * K : len;
  int lo = diag > lb ? diag - lb : 0;
  int hi = diag < la ? diag : la;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (!(sb[diag - m - 1] < sa[m])) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  int i = lo, j = diag - lo;
  long long prev = KEY_MIN;
  bool has_prev = false;
  if (DROP) {
    if (diag == 0) {
      prev = tile_pred;
      has_prev = tile_has_pred;
    } else {
      if (i > 0) prev = sa[i - 1];
      if (j > 0 && sb[j - 1] > prev) prev = sb[j - 1];
      has_prev = true;
    }
  }

  // K outputs, serially; a_key / b_key are the heads of the two windows
  long long rk[K], rv[K];
  long long a_key = sk[i];                  // sk[la + j] when i == la
  long long b_key = sk[la + j];             // the spare slot when j == lb
  unsigned keep = 0;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (diag + q < len) {
      const bool take_a = i < la && (j >= lb || a_key <= b_key);
      const long long key = take_a ? a_key : b_key;
      rv[q] = sv[take_a ? i : la + j];
      rk[q] = key;
      i += take_a;
      j += !take_a;
      const long long next = sk[take_a ? i : la + j];
      a_key = take_a ? next : a_key;
      b_key = take_a ? b_key : next;
      const bool kept = !DROP || !has_prev || key != prev;
      keep |= (unsigned)kept << q;
      cnt += kept;
      prev = key;
      has_prev = true;
    }
  }

  // block scan of the kept counts: this thread's offset in the tile
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < WARPS ? s_scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < WARPS) s_scan[lane] = v;
  }
  __syncthreads();
  const int kept_in_tile = s_scan[WARPS - 1];
  int off = x - cnt + (warp > 0 ? s_scan[warp - 1] : 0);

  // the tile's offset among the kept entries: warp 0 publishes the tile's
  // kept count (tile 0: its prefix), sums the earlier tiles' back to the
  // nearest prefix, and publishes this tile's prefix
  const long long t = w.t;
  if (DROP && warp == 0) {
    if (lane == 0)
      store_status(status + t, (t ? FLAG_COUNT : FLAG_PREFIX) | kept_in_tile);
    const long long base = t ? look_back(status, t, lane) : 0;
    if (lane == 0) {
      store_status(status + t,
                   FLAG_PREFIX | (unsigned long long)(base + kept_in_tile));
      *s_base = base;
      if (t == ntiles - 1) *total = base + kept_in_tile;
    }
  }

  // stage the kept outputs in shared memory (the windows are read out:
  // the scan's barriers came after every thread's merge)
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if ((keep >> q) & 1u) {
      sk[off] = rk[q];
      sv[off] = rv[q];
      ++off;
    }
  }
  __syncthreads();
  // entry e goes to ok[base + e]; thread slot r takes e = r - shift, so
  // that each warp writes one 256-byte-aligned span of 32 entries (an
  // output at any offset would split every warp's store over three lines)
  const long long base = DROP ? *s_base : w.d0;
  const int shift = (int)((reinterpret_cast<size_t>(ok + base) >> 3) & 31);
#pragma unroll
  for (int q = 0; q <= K; ++q) {
    const int e = tid + q * THREADS - shift;
    if (e >= 0 && e < kept_in_tile) {
      ok[base + e] = sk[e];
      ov[base + e] = sv[e];
    }
  }
}

// One block per tile: load the windows (all of a thread's loads in
// flight, through registers), then the tile's body.  Slot r of the loads
// reads A[i0 - sa + r] for r < LA, then B[j0 - sb + r - LA]: sa and sb
// (< 32) put each warp's 32 loads on one 256-byte-aligned span, and LA
// (la + sa rounded up to 32) starts B's on a warp.
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
    lsm_merge_tile(const long long* __restrict__ ak,
                   const long long* __restrict__ av, long long na,
                   const long long* __restrict__ bk,
                   const long long* __restrict__ bv, long long nb,
                   const long long* __restrict__ splits,
                   unsigned long long* status, unsigned long long* ticket,
                   long long* total, long long ntiles,
                   long long* __restrict__ ok, long long* __restrict__ ov) {
  extern __shared__ long long sk[];       // TILE + 1 keys, then values
  long long* sv = sk + TILE + 1;
  __shared__ int s_scan[WARPS];
  __shared__ long long s_base, s_pred, s_tile;

  const int tid = threadIdx.x;
  // with the drop, tiles in the order blocks start (the look-back waits
  // on lower tiles); without it, no tile waits on another
  if (DROP) {
    if (tid == 0) s_tile = (long long)atomicAdd(ticket, 1ull);
    __syncthreads();
  }
  const long long t = DROP ? s_tile : (long long)blockIdx.x;
  const Tile w = tile_of(t, splits[t], splits[t + 1], na + nb);
  const int sa = (int)((reinterpret_cast<size_t>(ak + w.i0) >> 3) & 31);
  const int sb = (int)((reinterpret_cast<size_t>(bk + w.j0) >> 3) & 31);
  const int LA = (w.la + sa + 31) & ~31;
  long long rk[K + 1], rv[K + 1];
#pragma unroll
  for (int q = 0; q <= K; ++q) {
    const int r = tid + q * THREADS;
    const int e = r < LA ? r - sa : r - LA - sb;
    if (r < LA ? (e >= 0 && e < w.la) : (e >= 0 && e < w.lb)) {
      rk[q] = r < LA ? ak[w.i0 + e] : bk[w.j0 + e];
      rv[q] = r < LA ? av[w.i0 + e] : bv[w.j0 + e];
    }
  }
  if (DROP && tid == 0) {
    long long p = KEY_MIN;
    if (w.i0 > 0) p = ak[w.i0 - 1];
    if (w.j0 > 0 && bk[w.j0 - 1] > p) p = bk[w.j0 - 1];
    s_pred = p;
  }
#pragma unroll
  for (int q = 0; q <= K; ++q) {
    const int r = tid + q * THREADS;
    const int e = r < LA ? r - sa : r - LA - sb;
    if (r < LA ? (e >= 0 && e < w.la) : (e >= 0 && e < w.lb)) {
      const int at = r < LA ? e : w.la + e;
      sk[at] = rk[q];
      sv[at] = rv[q];
    }
  }
  __syncthreads();
  tile_body<DROP>(sk, sv, w, s_pred, w.d0 > 0, status, total, ntiles, ok,
                  ov, s_scan, &s_base);
}

}  // namespace

// outputs per block, for the caller's scratch: 2 * ntiles + 3 int64
// (splits[ntiles + 1], status[ntiles], the tile counter, the kept total),
// ntiles = ceil((na + nb) / merge_tile_entries)
extern "C" const int merge_tile_entries = TILE;

extern "C" int merge_launch(const long long* ak, const long long* av,
                            long long na, const long long* bk,
                            const long long* bv, long long nb, long long* ok,
                            long long* ov, long long* scratch, int drop,
                            cudaStream_t stream) {
  const long long n = na + nb;
  if (n <= 0) return 0;
  const long long ntiles = (n + TILE - 1) / TILE;
  long long* splits = scratch;
  auto* status = reinterpret_cast<unsigned long long*>(scratch + ntiles + 1);
  auto* ticket = status + ntiles;
  long long* total = scratch + 2 * ntiles + 2;
  // probes a round per boundary: 32 where few boundaries leave the search
  // latency-bound, 8 where the reads of many bound it
  const int lg = ntiles < 1024 ? 5 : 3;
  const long long warps = (ntiles + 1 + (32 >> lg) - 1) / (32 >> lg);
  lsm_merge_partition<<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      ak, na, bk, nb, ntiles, lg, splits, status, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the windows' shared memory may pass 48 KB: raise the limit on every
  // call (it belongs to the current device)
  auto tile_kernel = drop ? lsm_merge_tile<true> : lsm_merge_tile<false>;
  err = cudaFuncSetAttribute(tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<(unsigned)ntiles, THREADS, SMEM_BYTES, stream>>>(
      ak, av, na, bk, bv, nb, splits, status, ticket, total, ntiles, ok, ov);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
