// FlashAttention forward for bfloat16 on Hopper's tensor cores: bf16 wgmma
// products on tiles that TMA loads into shared memory, an online softmax in
// float32 registers, causal and/or sliding-window masks, grouped-query
// heads, ragged lengths.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:96
// flash_attention_kernel (the Pallas body _attn_kernel at :36), together with
// the GQA expansion and (BH, S, d) transposes of its wrapper (ops.py:31-40),
// for bfloat16 inputs.  float32 inputs go to flash_attention.cu.
//
// It computes what the Pallas kernel computes for bf16 q, k, v: scores in
// float32 from bf16 q and k, the running max m and sum l in float32,
// P = exp(s - m) rounded to bf16 (the kernel's p.astype(v.dtype)) times bf16
// V accumulated in float32, masked scores at NEG_INF = -1e30, kv tiles that
// the mask wholly excludes skipped, and the output acc / max(l, 1e-30) in
// bf16.  It differs in rounding only: the scale 1/sqrt(d) is applied to the
// float32 score (the Pallas kernel scales bf16 q first) and exp2 of the
// score times log2(e) stands for exp.  Inputs are q (B, S, H, d) and k/v
// (B, Sk, KV, d) with 16-byte aligned bases and (batch, seq, head) strides
// that are positive multiples of 16 bytes (the wrapper copies anything else
// to a packed tensor); query head h reads kv head h / (H / KV).  Keys past
// Sk score -inf, query rows past S are not stored; d is 16, 32, 64, 96 or
// 128.
//
// What bounds it on the H100: operations.  Each unmasked (query, key) pair
// costs 2d multiply-adds (QK^T and PV), 4d flops: at the serving prefill
// (B 4, S 2048, H 40, KV 8, d 128, causal) that is 172 GFLOP, 0.17 ms at the
// tensor cores' 989 TFLOP/s in bf16, against 84 MB of q/k/v/o, 0.025 ms at
// 3.35 TB/s.  Only wgmma reaches that rate, so both products are wgmma, fed
// from shared memory by TMA with no thread spending a register on a copy.
//
// The design.  Work items are (batch, query head, 128-row q tile), ordered
// heaviest causal tiles first, items of one kv head and q tile next to
// each other (blocks running at once then share K/V tiles in the 50 MB
// L2).  The kernel is persistent: one block an SM walks one item of each
// round of gridDim.x items, rounds taken forward and backward in turn
// (so the blocks' sums of causal tiles come out even), and only its first
// item pays for an empty pipeline.  288 threads: two consumer warpgroups of 64 query rows each
// and one producer warp, whose one thread issues every TMA load, running
// ahead of the consumers: each item's Q into one of two buffers, its K and
// V tiles of 128 keys into a ring of two stages.  Each buffer and stage
// has a "full" mbarrier (the loads' bytes arrived) and an "empty" one (all
// eight consumer warps are done with it).  Tiles are 64 columns wide (128
// bytes, the 128-byte swizzle span; d 96 and 128 take two, d <= 64 one,
// TMA filling the columns past d with zeros), swizzled the same way in the
// tensor map and in the wgmma descriptors.  Per kv tile a consumer
// warpgroup runs S = Q K^T as 64 x 128 wgmmas over d/16 steps (both
// operands in shared memory, S in 64 float32 registers a thread), masks
// only a tile that the causal diagonal, the window edge or the end of Sk
// crosses, updates the row max and sum across the four threads of a row,
// converts P to bf16 in registers (the accumulator's fragment is the
// register A operand of the next wgmma), and runs O += P V with V read
// MN-major from shared memory (no transpose).  The item's epilogue divides
// by l and stores bf16 pairs through the output's strides.  Shared memory
// at d 128: 2 x 32 KB of Q and 2 x 64 KB of K/V, one block an SM.
//
// What holds it back on the H100: 9 warps put three on one of the SM's
// four register files, which caps a thread at 168 registers; the consumers
// use 166, so S_{i+1} = Q K_{i+1}^T cannot be issued under the softmax of
// tile i, and a warpgroup's softmax runs beside, not under, the tensor
// cores' work.  A variant with that overlap and a ping-pong between the
// warpgroups (256 threads, a consumer issuing the loads) was no faster; a
// producer warpgroup that hands registers over with setmaxnreg still
// compiled to 168 and spilled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                   // query rows per block
constexpr int BKV = 128;                  // keys per kv tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int CONSUMERS = 256;            // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int SPAN = 128;                 // bytes of a swizzled row: 64 bf16
constexpr int CHUNK = 128 * SPAN;         // a 128-row, 64-column tile chunk
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int CHUNKS = D > 64 ? 2 : 1;   // 64-column chunks
  static constexpr int DP = 64 * CHUNKS;          // d padded to the chunks
  static constexpr int KSTEPS = D / 16;           // k16 steps of Q K^T
  static constexpr int BYTES = CHUNKS * CHUNK;    // one Q, K or V tile
  // two Q buffers, the K and V rings, 1 KB to align the base, mbarriers
  static constexpr size_t SMEM =
      (size_t)BYTES * (2 + 2 * STAGES) + 1024 + 8 * (4 + 2 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of ``bar`` with this parity to complete.  A wait of
// 2^34 clocks (about 10 s) means a load that never lands: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > (1ll << 34)) __trap();
  }
}

// One box of the 4-D map (column, row, head, batch) into shared memory,
// completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// Tile i of K and of V (keys k0 ..) into ring stage i % STAGES, completing
// on that stage's "full" barrier.
template <int CHUNKS>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sK,
                                        uint32_t sV, uint32_t bar_full, int i,
                                        int k0, int kvh, int b) {
  const int s = i % STAGES;
  const uint32_t full = bar_full + 8 * s, off = s * CHUNKS * CHUNK;
  mbar_expect_tx(full, 2 * CHUNKS * CHUNK);
  for (int c = 0; c < CHUNKS; ++c) {
    tma_load(sK + off + c * CHUNK, tk, full, 64 * c, k0, kvh, b);
    tma_load(sV + off + c * CHUNK, tv, full, 64 * c, k0, kvh, b);
  }
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, float32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both
// operands K-major (the 16-deep dimension contiguous in each row); D is
// overwritten when ``accumulate`` is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// smem), B MN-major (its 64 columns contiguous in each row: trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// smem), B MN-major (its 128 columns contiguous in each row: trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, b);
  } else {
    wgmma_rs_n64(o, a, b);
  }
}

// 2^x, flushing results below 2^-126 to 0 (they are below any bf16 P
// that moves a sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One thread's rows ra and rb: the running max (raw score units) and its
// part of the running sums (the four threads of a row add theirs at the
// end).
struct Rows {
  float m_a, m_b, l_a, l_b;
};

// Mask a tile that the causal diagonal, the window edge or the end of Sk
// crosses; update the running max of each row (across the four threads
// that hold it) and its sum; overwrite S with P = 2^((S - max) * c).
// alpha_a/b rescale what was summed before.  (S - max) is formed before
// the product, so two masked scores give 2^0 exactly, as exp(s - m) does.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], bool mask,
                                             int k0, int ra, int rb, int cq,
                                             int Sk, int causal, int window,
                                             float c, Rows& r, float& alpha_a,
                                             float& alpha_b) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + cq + (e & 1);
        const int qpos = e < 2 ? ra : rb;
        bool keep = true;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        const float x = keep ? sc[4 * j + e] : NEG_INF;
        sc[4 * j + e] = kpos < Sk ? x : -INFINITY;
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
  }
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  alpha_a = ex2((r.m_a - mn_a) * c);
  alpha_b = ex2((r.m_b - mn_b) * c);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = ex2((sc[4 * j] - mn_a) * c);
    sc[4 * j + 1] = ex2((sc[4 * j + 1] - mn_a) * c);
    sc[4 * j + 2] = ex2((sc[4 * j + 2] - mn_b) * c);
    sc[4 * j + 3] = ex2((sc[4 * j + 3] - mn_b) * c);
    ls_a += sc[4 * j] + sc[4 * j + 1];
    ls_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l_a = r.l_a * alpha_a + ls_a;
  r.l_b = r.l_b * alpha_b + ls_b;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// P in bf16, laid out as the A operand of m64k16: registers 4 kk .. 4 kk + 3
// hold keys 16 kk .. 16 kk + 15 of rows ra and rb (the accumulator's own
// fragment order, so no shuffle)
__device__ __forceinline__ void to_bf16(uint32_t (&p)[32],
                                        const float (&sc)[64]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

// Whether the kv tile at k0 needs a mask for the q tile at q0: the causal
// diagonal, the window's edge or the end of Sk crosses it.
__device__ __forceinline__ bool must_mask(int k0, int q0, int Sk, int causal,
                                          int window) {
  return (causal && k0 + BKV - 1 > q0) ||
         (window > 0 && k0 < q0 + BQ - window) || k0 + BKV > Sk;
}

// S = Q K^T for this warpgroup's 64 rows against a 128-key K tile: d/16
// steps, each 32 bytes further along the swizzled rows, then the next chunk.
template <int KSTEPS>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t q,
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk / 4) * CHUNK + (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(q + off, 16, 1024),
                  sw128_desc(k + off, 16, 1024), kk > 0);
  }
}

// O += P V over the tile's 128 keys: 8 steps of 16 key rows (2 KB each);
// V is MN-major, its two 64-column chunks CHUNK bytes apart.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&p)[32], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_pv<DP>(o, a, sw128_desc(v + kk * 16 * SPAN, CHUNK, 1024));
  }
}

// One work item: a 128-row q tile of one (batch, head) and the kv tiles it
// reads.  Items run heaviest causal tiles first; items of one kv head and q
// tile are neighbours, so blocks running at once share K/V tiles in L2.
struct Item {
  int q0, b, h, kt_begin, n_tiles;
};

// The block's n-th item: rounds of gridDim.x items, walked forward in even
// rounds and backward in odd ones, so each block's sum of causal tiles
// comes out even (the heaviest items pair with the lightest of the next
// round).
__device__ __forceinline__ int item_index(int n) {
  const int j = (n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return n * gridDim.x + j;
}

__device__ __forceinline__ Item item_of(int t, int B, int S, int Sk, int H,
                                        int causal, int window) {
  const int bh = B * H;
  Item w;
  w.q0 = ((S + BQ - 1) / BQ - 1 - t / bh) * BQ;
  w.b = t % bh / H;
  w.h = t % bh % H;
  int kt_end = (Sk + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, (w.q0 + BQ - 1) / BKV + 1);
  w.kt_begin = 0;
  if (window > 0) {
    // the first tile holding a key inside the first row's window
    const int lo = w.q0 - window + 1;
    if (lo > 0) w.kt_begin = lo / BKV;
  }
  w.n_tiles = max(kt_end - w.kt_begin, 0);
  return w;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, long long o_sb,
                             long long o_ss, long long o_sh, int B, int S,
                             int Sk, int H, int group, int causal, int window,
                             float scale_log2) {
  using T = Tile<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // n: + n BYTES
  const uint32_t sK = sQ + 2 * T::BYTES;         // stage s: + s * BYTES
  const uint32_t sV = sK + STAGES * T::BYTES;
  const uint32_t bar_qfull = sV + STAGES * T::BYTES;   // Q buffer n: + 8 n
  const uint32_t bar_qempty = bar_qfull + 16;
  const uint32_t bar_full = bar_qempty + 16;           // stage s: + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int n_items = (S + BQ - 1) / BQ * B * H;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int n = 0; n < 2; ++n) {
      mbar_init(bar_qfull + 8 * n, 1);
      mbar_init(bar_qempty + 8 * n, CONSUMERS / 32);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one thread loads each item's Q into one of two
    // buffers and its kv tiles into the ring, running ahead of the
    // consumers as far as free buffers and stages allow
    if (tid == CONSUMERS) {
      int it = 0;   // kv tiles loaded so far, over all items
      for (int n = 0, t = item_index(0); t < n_items; t = item_index(++n)) {
        const Item w = item_of(t, B, S, Sk, H, causal, window);
        const int qb = n % 2;
        if (n >= 2) mbar_wait(bar_qempty + 8 * qb, (n / 2 - 1) & 1);
        mbar_expect_tx(bar_qfull + 8 * qb, T::BYTES);
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load(sQ + qb * T::BYTES + c * CHUNK, &tm_q, bar_qfull + 8 * qb,
                   64 * c, w.q0, w.h, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++it) {
          if (it >= STAGES)
            mbar_wait(bar_empty + 8 * (it % STAGES), (it / STAGES - 1) & 1);
          load_kv<T::CHUNKS>(&tm_k, &tm_v, sK, sV, bar_full, it,
                             (w.kt_begin + i) * BKV, w.h / group, w.b);
        }
      }
    }
    return;
  }

  // a consumer thread: rows row and row + 8 of the q tile (its warpgroup's
  // 64 from wg * 64), columns 8 j + cq and 8 j + cq + 1 of each 8-column
  // block j of S and O
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  int it = 0;
  for (int n = 0, t = item_index(0); t < n_items; t = item_index(++n)) {
    const Item w = item_of(t, B, S, Sk, H, causal, window);
    const int qb = n % 2;
    const int ra = w.q0 + row, rb = ra + 8;
    const uint32_t q_wg = sQ + qb * T::BYTES + wg * 64 * SPAN;
    float acc[T::DP / 2];
#pragma unroll
    for (int j = 0; j < T::DP / 2; ++j) acc[j] = 0.f;
    Rows rows{NEG_INF, NEG_INF, 0.f, 0.f};
    float sc[64];
    uint32_t p[32];

    mbar_wait(bar_qfull + 8 * qb, (n / 2) & 1);
    for (int i = 0; i < w.n_tiles; ++i, ++it) {
      const int s = it % STAGES;
      const int k0 = (w.kt_begin + i) * BKV;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      wgmma_fence();
      issue_s<T::KSTEPS>(sc, q_wg, sK + s * T::BYTES);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      float alpha_a, alpha_b;
      softmax_tile(sc, must_mask(k0, w.q0, Sk, causal, window), k0, ra, rb,
                   cq, Sk, causal, window, scale_log2, rows, alpha_a,
                   alpha_b);
#pragma unroll
      for (int j = 0; j < T::DP / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }
      to_bf16(p, sc);
      reg_fence(acc);
      wgmma_fence();
      issue_pv<T::DP>(acc, p, sV + s * T::BYTES);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      reg_fence(p);   // P stays live until the product that reads it is done
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_qempty + 8 * qb);   // Q read for good

    float l_a = rows.l_a, l_b = rows.l_b;
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, m);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, m);
    }
    const float lg_a = fmaxf(l_a, 1e-30f), lg_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = o + w.b * o_sb + w.h * o_sh;
#pragma unroll
    for (int j = 0; j < T::DP / 8; ++j) {
      if (8 * j >= D) continue;
      const int col = 8 * j + cq;
      if (ra < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)ra * o_ss + col) =
            __floats2bfloat162_rn(acc[4 * j] / lg_a, acc[4 * j + 1] / lg_a);
      if (rb < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rb * o_ss + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / lg_b,
                                  acc[4 * j + 3] / lg_b);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, rows, heads, d) bf16 tensor: boxes of 64 columns x 128
// rows of one head, 128-byte swizzled, zeros past every edge.  Strides in
// elements.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base, int d,
                int rows, int heads, int batch, long long s_row,
                long long s_head, long long s_batch) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  long long st[12];  // (batch, seq, head) element strides of q, k, v, o
  int B, S, Sk, H, KV, causal, window;
  float scale;
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const long long* st = a.st;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, a.q, D, a.S, a.H, a.B, st[1], st[2], st[0]) ||
      !tensor_map(&tk, encode, a.k, D, a.Sk, a.KV, a.B, st[4], st[5], st[3]) ||
      !tensor_map(&tv, encode, a.v, D, a.Sk, a.KV, a.B, st[7], st[8], st[6]))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Tile<D>::SMEM;
  // set on every call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM walks the work items
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const long long items = (long long)((a.S + BQ - 1) / BQ) * a.B * a.H;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  flash_attention_wgmma_kernel<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), st[9], st[10], st[11],
      a.B, a.S, a.Sk, a.H, a.H / a.KV, a.causal, a.window, a.scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, seq, head) of q, then of k, v and o; the
// head dimension is contiguous, and q/k/v's bases and strides are 16-byte
// multiples.  window <= 0: no sliding window.  scale: 1/sqrt(D), rounded to
// float32 by the caller.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int B, int S, int Sk,
    int H, int KV, int D, int causal, int window, float scale,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o,
               {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                o_ss, o_sh},
               B, S, Sk, H, KV, causal, window, scale};
  switch (D) {
    case 16: return launch<16>(a, stream);
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 96: return launch<96>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
