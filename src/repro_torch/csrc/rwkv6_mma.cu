// RWKV-6 WKV recurrence, forward, for bfloat16 r/k/v on Hopper's tensor
// cores: the chunked form, with the state carried once a chunk.
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:74 rwkv6_kernel (the Pallas
// body _wkv_kernel at :28), together with the (BH, S, n) transposes and the
// tile of u that its wrapper (ops.py:18-24) makes, for bfloat16 r/k/v.
// float32 r/k/v go to rwkv6.cu, the per-step kernel.
//
// It computes the contract of the Pallas kernel, ref.py::wkv_ref, on an
// n x n float32 state S (S_0 = 0):
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//
// r/k/v are (B, S, H, n) bfloat16 and logw (B, S, H, n) float32 (< 0), each
// with (batch, seq, head) strides that are multiples of 16 bytes and a
// contiguous last dimension, on 16-byte aligned bases (the wrapper copies
// anything else); u is (H, n) float32, contiguous.  Outputs: y (B, S, H, n)
// and the final state (B, H, n, n), float32, contiguous.  n is 16, 32 or
// 64; S is any length (the last chunk is padded with r = k = v = logw = 0,
// which changes nothing).  kernels/rwkv6/ref.py::wkv_two_level_ref repeats
// this arithmetic in torch ops for the CPU tests.
//
// What bounds it on the H100: bytes.  At the rwkv6-3b prefill (B 4, S 2048,
// H 40, n 64) the function moves 296 MB (r/k/v 126 MB in bf16, logw and y
// 84 MB each, the state 2.6 MB): 0.088 ms at 3.35 TB/s.  Its products (per
// token and head, 2n^2 each for r S and the state update, about C n each
// for the intra-chunk matrix and its product with v, C = 32) are 6.7 GFLOP:
// 0.007 ms at the bf16 tensor-core rate, 0.02 ms three times over for the
// operand splits below.  The per-step kernel (rwkv6.cu) is held at 0.48 ms
// by the latency of 2048 steps in order; here the order in time costs S / 32
// state updates, each a few tensor-core products, and what is left is the
// latency of one chunk's work in one block: that is what the design below
// keeps short.
//
// The design.  One block of 128 threads (4 warps) per (batch, head), 160
// blocks at the prefill, two resident per SM.  The block walks the sequence
// in chunks of C = 32 tokens, cut into sub-chunks of 16 and halves of 8; a
// ring of three stages holds the inputs of the chunk being computed and of
// the next two, which cp.async fetches in 16-byte pieces.  Each warp owns
// 16 value columns m of the state, kept as the float32 accumulator of S^T
// (rows m, columns i) in registers across chunks: it is never rounded, only
// split when it is an operand.  The work of a chunk:
//
// A. The decays, one thread per (2 columns, 8-token half): w = e^{logw}
//    (written over logw), its running products forward and backward within
//    the half, and by shuffles the other half's and the other sub-chunk's
//    totals.  All decays are products of w <= 1 (one exponential per
//    element), i.e. e^{sum of logw over a span}, never e^{-sum}: nothing
//    overflows at any decay (a one-level split, (r e^{Lc_prev}) (k
//    e^{-Lc})^T, overflows within 13 tokens at logw -7).  From them: r and
//    k decayed from / to the chunk's ends (R~ = r e^{Lc_prev}, K~ = k
//    e^{total - Lc}), from / to the two sub-chunks' boundary (r_hat of
//    sub-chunk 1, k_hat of sub-chunk 0: the reference L_p of Gated Linear
//    Attention's secondary chunking, arXiv 2312.06635), and from / to each
//    sub-chunk's middle (r8, k8), and e^{total}.
// B. The intra-chunk matrix att (C x C, lower triangle), as blocks that a
//    reference between them makes one product each, on the tensor cores:
//    r_hat_1 k_hat_0^T (16 x 16) and, in each sub-chunk, r8 k8^T (8 x 8).
//    What is left, the four 8 x 8 triangles along the diagonal, is formed
//    pairwise on the CUDA cores as running products of w: a lane owns a
//    pair of key tokens (j, 7 - j) and n / 8 columns, walks the 7 query
//    tokens after them (h_j = k_j prod w, att[t, j] = r_t . h_j), and 8
//    lanes sum their columns by shuffles; the u bonus sits on the diagonal.
// C. On the tensor cores, per warp, for its 16 columns: y = R~ S + att v,
//    and the state, S^T <- S^T diag(e^{total}) + V^T K~.
//
// What sets the time: each scheduler runs one warp of the block (two when
// two blocks share an SM), and that warp issues the whole chunk's work,
// with nothing else to switch to while an instruction waits on shared
// memory, a shuffle or the mma.sync before it (on the H100 ~25 cycles for
// a dependent product, against ~6 between independent ones:
// tools/rwkv6_probe.py).  So a chunk has two barriers and two stretches of
// straight-line code, each mixing CUDA-core and tensor-core work that does
// not depend on each other: A of chunk c with the end of chunk c - 1 (att
// v, then y's rows stored), and B of chunk c with R~ S and the state
// update of chunk c and the copies of chunk c + 2 (into the stage that
// chunk c - 1 has left).  Products accumulate in two or three
// accumulators, one per split term, which shortens the chains of
// dependent mma.
//
// Precision.  The products are mma.sync m16n8k16 in bf16 with float32
// accumulation (TF32 m16n8k8 would round every operand to 11 bits).  A
// float32 operand x is split into hi = bf16(x) and lo = bf16(x - hi), 16
// bits together, and a product a b is hi_a hi_b + hi_a lo_b + lo_a hi_b;
// v is bf16 already, so att v and V^T K~ take two terms.  One-pass TF32
// products miss the contract (5e-2 on y) at a slow decay, where the state
// sums ~150 tokens; the split form holds it at every decay (the twin's
// rounding="tf32" and "bf16_split", tests/test_torch_rwkv.py).  The
// operands are split once, where they are made (in A and B, and S before
// its products), so the products only load fragments (ldmatrix, .trans
// where the layout is k-major) and multiply.
//
// Shared memory.  Token rows are padded (bf16 rows of n + 8, float rows of
// n + 4: 16-byte rows whose 8-row ldmatrix phases hit 32 distinct banks)
// and every group of 8 rows is shifted by 32 bytes (bf16) or 64 bytes
// (float), so that a warp touching the same columns of rows 8 apart (phase
// A's halves and sub-chunks) hits distinct banks too.  113,152 bytes at
// n = 64: two blocks an SM.
//
// ptxas (sm_90a, -O3, CUDA 12 on the H100 machine): 204 registers at
// n = 64, 183 at n = 32, 153 at n = 16; no stack frame, no spills, no
// static shared memory (the 113,152 bytes above are dynamic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // tokens per chunk
constexpr int SUB = 16;        // tokens per sub-chunk
constexpr int HALF = 8;        // tokens per half sub-chunk
constexpr int THREADS = 128;   // 4 warps
constexpr int NSTAGE = 3;      // chunks of raw inputs in the ring
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared memory: element strides and byte offsets.  Row r of a token tile
// sits at r * LD + (r / 8) * SK elements.
template <int N>
struct Smem {
  static constexpr int LDB = N + 8, SKB = 16;   // bf16 tiles
  static constexpr int LDW = N + 4, SKW = 16;   // float tiles
  static constexpr int LDA = C + 8;             // att, bf16, not shifted
  static constexpr int T32 = (C * LDB + 4 * SKB) * 2;      // 32-row tile
  static constexpr int T16 = (SUB * LDB + 2 * SKB) * 2;    // 16-row tile
  static constexpr int TW = (C * LDW + 4 * SKW) * 4;       // logw / w
  static constexpr int STAGE = 3 * T32 + TW;    // r, k, v, logw
  static constexpr int RT = NSTAGE * STAGE;     // R~ hi, lo
  static constexpr int KT = RT + 2 * T32;       // K~ hi, lo
  // r_hat of sub-chunk 1 and k_hat of sub-chunk 0, hi, lo; 64 bytes apart
  // from each other's banks, since phase A writes both in one instruction
  static constexpr int RO = KT + 2 * T32;
  static constexpr int KO = RO + 2 * T16 + 64;
  // r8 (second halves) and k8 (first halves), hi, lo
  static constexpr int R8 = KO + 2 * T16;
  static constexpr int K8 = R8 + 2 * T16 + 64;
  static constexpr int ATT = K8 + 2 * T16;      // att hi, lo
  static constexpr int U = ATT + 2 * C * LDA * 2;
  static constexpr int ET = U + N * 4;          // e^{total}
  static constexpr int BYTES = ET + N * 4;
  static_assert(N * (N + 4) * 4 <= RT, "the final state is staged in the "
                "ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b, a 16 x 16 bf16 (row-major fragment), b 16 x 8 bf16 (col-major)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a hi/lo pair of bf16x2 words for two floats (the lower index in the low
// half, as a fragment holds a column pair)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, int at,
                                          float x) {
  const bf16 h = __float2bfloat16_rn(x);
  hi[at] = h;
  lo[at] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// 2^x, flushing results below float32's normal range to 0 (a decay that
// small changes no sum it enters)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack(uint32_t w, float& x0, float& x1) {
  x0 = __uint_as_float(w << 16);
  x1 = __uint_as_float(w & 0xffff0000u);
}

// CPL consecutive bf16 (CPL = 8, 4 or 2) as floats, one vector load
template <int CPL>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&o)[CPL]) {
  if constexpr (CPL == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    unpack(q.x, o[0], o[1]);
    unpack(q.y, o[2], o[3]);
    unpack(q.z, o[4], o[5]);
    unpack(q.w, o[6], o[7]);
  } else if constexpr (CPL == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    unpack(q.x, o[0], o[1]);
    unpack(q.y, o[2], o[3]);
  } else {
    unpack(*reinterpret_cast<const uint32_t*>(p), o[0], o[1]);
  }
}

template <int CPL>
__device__ __forceinline__ void load_f32(const float* p, float (&o)[CPL]) {
  if constexpr (CPL == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    o[0] = q.x;
    o[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < CPL; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c);
      o[c] = q.x;
      o[c + 1] = q.y;
      o[c + 2] = q.z;
      o[c + 3] = q.w;
    }
  }
}

// a hi/lo pair of bf16x2 words for two floats, stored at element `at` of
// the hi and lo tiles
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int at,
                                            float x0, float x1) {
  uint32_t h, l;
  split2(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi + at) = h;
  *reinterpret_cast<uint32_t*>(lo + at) = l;
}

constexpr unsigned FULL = 0xffffffffu;

template <int N>
__global__ void __launch_bounds__(THREADS, 2)
rwkv6_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ state, long long r_sb, long long r_ss,
                 long long r_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long w_sb, long long w_ss,
                 long long w_sh, int S, int H) {
  using L = Smem<N>;
  constexpr int LDB = L::LDB, SKB = L::SKB, LDW = L::LDW, SKW = L::SKW;
  constexpr int LDA = L::LDA;
  constexpr int CPL = N / 8;   // columns per lane in a triangle
  constexpr int KS = N / 16;   // k16 steps over the columns i
  constexpr int NT = N / 8;    // n8 tiles over the columns i
  extern __shared__ __align__(128) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<bf16*>(smem + off); };
  bf16* const rt_hi = tile(L::RT);
  bf16* const rt_lo = tile(L::RT + L::T32);
  bf16* const kt_hi = tile(L::KT);
  bf16* const kt_lo = tile(L::KT + L::T32);
  bf16* const ro_hi = tile(L::RO);
  bf16* const ro_lo = tile(L::RO + L::T16);
  bf16* const ko_hi = tile(L::KO);
  bf16* const ko_lo = tile(L::KO + L::T16);
  bf16* const r8_hi = tile(L::R8);
  bf16* const r8_lo = tile(L::R8 + L::T16);
  bf16* const k8_hi = tile(L::K8);
  bf16* const k8_lo = tile(L::K8 + L::T16);
  bf16* const at_hi = tile(L::ATT);
  bf16* const at_lo = at_hi + C * LDA;
  float* const su = reinterpret_cast<float*>(smem + L::U);
  float* const etot = reinterpret_cast<float*>(smem + L::ET);
  // element offset of token row i of a bf16 / float tile
  auto rb = [](int i) { return i * LDB + (i >> 3) * SKB; };
  auto rw = [](int i) { return i * LDW + (i >> 3) * SKW; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix l / 8
  const int mat = lane >> 3, mrow = lane & 7;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nchunks = (S + C - 1) / C;

  const bf16* const gr = r + b * r_sb + h * r_sh;
  const bf16* const gk = k + b * k_sb + h * k_sh;
  const bf16* const gv = v + b * v_sb + h * v_sh;
  const float* const gw = logw + b * w_sb + h * w_sh;
  float* const yb = y + ((long long)b * S * H + h) * N;
  // sequence strides in bytes fit in 31 bits (the wrapper sees to it), so
  // a row's offset is one 32 x 32 -> 64-bit multiply
  const int rss = (int)r_ss, kss = (int)k_ss, vss = (int)v_ss;
  const int wss = (int)w_ss;

  auto stage = [&](int c) { return smem + (c % NSTAGE) * L::STAGE; };

  // chunk c's rows into its stage, rows past S zero-filled; each thread
  // copies the same 16-byte pieces of every chunk
  auto fetch = [&](int c) {
    if (c < nchunks) {
      unsigned char* const buf = stage(c);
      bf16* const sr = reinterpret_cast<bf16*>(buf);
      bf16* const sk = reinterpret_cast<bf16*>(buf + L::T32);
      bf16* const sv = reinterpret_cast<bf16*>(buf + 2 * L::T32);
      float* const sw = reinterpret_cast<float*>(buf + 3 * L::T32);
      constexpr int PB = N / 8, PW = N / 4;   // 16-byte pieces per row
#pragma unroll
      for (int q = 0; q < (C * PB + THREADS - 1) / THREADS; ++q) {
        const int e = tid + q * THREADS;
        if (C * PB % THREADS == 0 || e < C * PB) {
          const int row = e / PB, col = 8 * (e % PB), t = c * C + row;
          const int tt = t < S ? t : 0, bytes = t < S ? 16 : 0;
          const int at = rb(row) + col;
          cp_async16(sr + at, gr + (long long)tt * rss + col, bytes);
          cp_async16(sk + at, gk + (long long)tt * kss + col, bytes);
          cp_async16(sv + at, gv + (long long)tt * vss + col, bytes);
        }
      }
#pragma unroll
      for (int q = 0; q < (C * PW + THREADS - 1) / THREADS; ++q) {
        const int e = tid + q * THREADS;
        if (C * PW % THREADS == 0 || e < C * PW) {
          const int row = e / PW, col = 4 * (e % PW), t = c * C + row;
          const int tt = t < S ? t : 0;
          cp_async16(sw + rw(row) + col, gw + (long long)tt * wss + col,
                     t < S ? 16 : 0);
        }
      }
    }
    cp_commit();
  };

  for (int i = tid; i < N; i += THREADS) su[i] = u[h * N + i];
  for (int c = 0; c < NSTAGE - 1; ++c) fetch(c);

  // S^T, rows m = 16 warp + g (+8), columns i = 8 ni + 2 t4 (+1)
  float st[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
    st[ni][0] = st[ni][1] = st[ni][2] = st[ni][3] = 0.f;

  // the warps with state columns (and phase A's), 0 .. n / 16 - 1: all
  // four at n = 64
  const bool cw = N / 16 == 4 || warp < N / 16;
  const int m0 = 16 * warp;
  const int arow = mrow + 8 * (mat & 1), acol = 8 * (mat >> 1);
  const int vrow = mrow + 8 * (mat & 1), vcol = m0 + 8 * (mat >> 1);
  // y's hi.hi terms and its cross terms in two accumulators: two chains of
  // dependent mma half as long.  They carry chunk c's inter-chunk part
  // from its phase B to the next chunk's phase A, where finish(c) adds the
  // intra-chunk part and stores the rows.
  float yacc[2][2][4], yx[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[mt][nt][q] = yx[mt][nt][q] = 0.f;

  // chunk cc's y: att v (att from its phase B, v from its stage), then
  // the rows; cc = -1 stores nothing
  auto finish = [&](int cc) {
    const bf16* const pv = reinterpret_cast<const bf16*>(
        stage(cc + NSTAGE) + 2 * L::T32);
    if (cw) {
      // intra-chunk: y[t, m] += att[t, :] v[:, m], key blocks up to t's
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t vf[4];   // B fragments of v for columns m0.., m0 + 8..
        ldsm_x4_t(pv + rb(16 * kk + vrow) + vcol, vf);
#pragma unroll
        for (int mt = kk; mt < 2; ++mt) {
          uint32_t ah[4], al[4];
          const int at = (16 * mt + arow) * LDA + 16 * kk + acol;
          ldsm_x4(at_hi + at, ah);
          ldsm_x4(at_lo + at, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma(yx[mt][nt], al, vf[2 * nt], vf[2 * nt + 1]);
            mma(yacc[mt][nt], ah, vf[2 * nt], vf[2 * nt + 1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = cc * C + 16 * mt + g + 8 * half;
          if (t >= 0 && t < S) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              *reinterpret_cast<float2*>(
                  yb + (long long)t * H * N + m0 + 8 * nt + 2 * t4) =
                  make_float2(
                      yacc[mt][nt][2 * half] + yx[mt][nt][2 * half],
                      yacc[mt][nt][2 * half + 1] + yx[mt][nt][2 * half + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[mt][nt][q] = yx[mt][nt][q] = 0.f;
  };

  for (int c = 0; c < nchunks; ++c) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();   // chunk c has landed for every thread
    unsigned char* const cur = stage(c);
    const bf16* const sr = reinterpret_cast<const bf16*>(cur);
    const bf16* const sk = reinterpret_cast<const bf16*>(cur + L::T32);
    const bf16* const sv = reinterpret_cast<const bf16*>(cur + 2 * L::T32);
    float* const sw = reinterpret_cast<float*>(cur + 3 * L::T32);

    // ---- A: the decays and the scaled operands, and meanwhile the last
    // chunk's y -----------------------------------------------------------
    finish(c - 1);
    // lane = 8 column pairs x 2 halves x 2 sub-chunks; every load comes
    // before the first store (the compiler cannot tell the shared arrays
    // apart, so a store would hold back later loads)
    if (cw) {
      const int col = 2 * (8 * warp + (lane & 7));
      const int hf = (lane >> 3) & 1, p = lane >> 4;
      // the half's rows share one shift: row t0 + tau is tau rows on
      const int t0 = SUB * p + HALF * hf;
      const int ab = rb(t0) + col, wb = rw(t0) + col;
      float w0[HALF], w1[HALF], r0[HALF], r1[HALF], k0[HALF], k1[HALF];
#pragma unroll
      for (int tau = 0; tau < HALF; ++tau) {
        const float2 lw =
            *reinterpret_cast<const float2*>(sw + wb + tau * LDW);
        w0[tau] = ex2(lw.x * LOG2E);
        w1[tau] = ex2(lw.y * LOG2E);
        unpack(*reinterpret_cast<const uint32_t*>(sr + ab + tau * LDB),
               r0[tau], r1[tau]);
        unpack(*reinterpret_cast<const uint32_t*>(sk + ab + tau * LDB),
               k0[tau], k1[tau]);
      }
      // r decayed from the half's start, k to its end (r8, k8)
      float f0 = 1.f, f1 = 1.f;
#pragma unroll
      for (int tau = 0; tau < HALF; ++tau) {
        r0[tau] *= f0;
        r1[tau] *= f1;
        f0 *= w0[tau];
        f1 *= w1[tau];
      }
      float e0 = 1.f, e1 = 1.f;
#pragma unroll
      for (int tau = HALF - 1; tau >= 0; --tau) {
        k0[tau] *= e0;
        k1[tau] *= e1;
        e0 *= w0[tau];
        e1 *= w1[tau];
      }
      // f: the half's total decay; the other half's, the sub-chunk's
      // and the other sub-chunk's
      const float oh0 = __shfl_xor_sync(FULL, f0, 8);
      const float oh1 = __shfl_xor_sync(FULL, f1, 8);
      const float sc0 = f0 * oh0, sc1 = f1 * oh1;
      const float os0 = __shfl_xor_sync(FULL, sc0, 16);
      const float os1 = __shfl_xor_sync(FULL, sc1, 16);
      if (p == 0 && hf == 0) {
        etot[col] = sc0 * os0;
        etot[col + 1] = sc1 * os1;
      }
      // r8 -> r_hat (from the sub-chunk's start) -> R~ (the chunk's);
      // k8 -> k_hat (to the sub-chunk's end) -> K~ (the chunk's)
      const float fr0 = hf ? oh0 : 1.f, fr1 = hf ? oh1 : 1.f;
      const float fk0 = hf ? 1.f : oh0, fk1 = hf ? 1.f : oh1;
      const float gr0 = p ? os0 : 1.f, gr1 = p ? os1 : 1.f;
      const float gk0 = p ? 1.f : os0, gk1 = p ? 1.f : os1;
      // r_hat of sub-chunk 1 or k_hat of sub-chunk 0 (rows 8 hf + tau);
      // r8 of a second half or k8 of a first (rows 8 p + tau)
      bf16* const oh = (p ? ro_hi : ko_hi) + rb(HALF * hf) + col;
      bf16* const ol = (p ? ro_lo : ko_lo) + rb(HALF * hf) + col;
      bf16* const eh = (hf ? r8_hi : k8_hi) + rb(HALF * p) + col;
      bf16* const el = (hf ? r8_lo : k8_lo) + rb(HALF * p) + col;
#pragma unroll
      for (int tau = 0; tau < HALF; ++tau) {
        const int at = ab + tau * LDB;
        *reinterpret_cast<float2*>(sw + wb + tau * LDW) =
            make_float2(w0[tau], w1[tau]);   // w, for the triangles
        const float rh0 = r0[tau] * fr0, rh1 = r1[tau] * fr1;
        const float kh0 = k0[tau] * fk0, kh1 = k1[tau] * fk1;
        store_split(rt_hi, rt_lo, at, rh0 * gr0, rh1 * gr1);
        store_split(kt_hi, kt_lo, at, kh0 * gk0, kh1 * gk1);
        store_split(oh, ol, tau * LDB, p ? rh0 : kh0, p ? rh1 : kh1);
        store_split(eh, el, tau * LDB, hf ? r0[tau] : k0[tau],
                    hf ? r1[tau] : k1[tau]);
      }
    }
    __syncthreads();

    // ---- B: the intra-chunk matrix, and meanwhile on the tensor cores
    // what does not need it: y's inter-chunk part and the state update.
    // One run of straight-line code, so that the scheduler overlaps the
    // triangles' CUDA-core work with the products, and with the copies
    // of chunk c + 2 into the stage that chunk c - 1 has left.
    fetch(c + NSTAGE - 1);
    if (cw) {
      // inter-chunk: y[t, m] += R~[t, :] S[:, m]; S's rows 16 kk .. as the
      // B fragments of columns m0 + 8 nt .., split
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            split2(st[2 * kk + q][2 * nt], st[2 * kk + q][2 * nt + 1],
                   bh[nt][q], bl[nt][q]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ah[4], al[4];
          const int at = rb(16 * mt + arow) + 16 * kk + acol;
          ldsm_x4(rt_hi + at, ah);
          ldsm_x4(rt_lo + at, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma(yx[mt][nt], ah, bl[nt][0], bl[nt][1]);
            mma(yx[mt][nt], al, bh[nt][0], bh[nt][1]);
            mma(yacc[mt][nt], ah, bh[nt][0], bh[nt][1]);
          }
        }
      }
      // the state: S^T <- S^T diag(e^{total}) + V^T K~
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const float e0 = etot[8 * ni + 2 * t4];
        const float e1 = etot[8 * ni + 2 * t4 + 1];
        st[ni][0] *= e0;
        st[ni][1] *= e1;
        st[ni][2] *= e0;
        st[ni][3] *= e1;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t va[4];   // A fragment of V^T: rows m0.., columns j
        ldsm_x4_t(sv + rb(16 * kk + mrow + 8 * (mat >> 1)) + m0 +
                      8 * (mat & 1),
                  va);
#pragma unroll
        for (int ni = 0; ni < NT; ni += 2) {
          uint32_t fh[4], fl[4];   // K~ for columns 8 ni.., 8 ni + 8..
          const int at = rb(16 * kk + vrow) + 8 * ni + 8 * (mat >> 1);
          ldsm_x4_t(kt_hi + at, fh);
          ldsm_x4_t(kt_lo + at, fl);
          mma(st[ni], va, fl[0], fl[1]);
          mma(st[ni], va, fh[0], fh[1]);
          mma(st[ni + 1], va, fl[2], fl[3]);
          mma(st[ni + 1], va, fh[2], fh[3]);
        }
      }
    }
    {
      // the triangle of half (p, hf) = (warp / 2, warp % 2): key tokens ja
      // and jb of the half, n / 8 columns a lane
      const int base = SUB * (warp >> 1) + HALF * (warp & 1);
      const int jp = lane >> 3, ig = lane & 7;
      const int ja = jp, jb = HALF - 1 - jp, c0 = ig * CPL;
      float uu[CPL], ka[CPL], kq[CPL], ra[CPL], rq[CPL];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) uu[cc] = su[c0 + cc];
      load_bf16<CPL>(sk + rb(base + ja) + c0, ka);
      load_bf16<CPL>(sk + rb(base + jb) + c0, kq);
      load_bf16<CPL>(sr + rb(base + ja) + c0, ra);
      load_bf16<CPL>(sr + rb(base + jb) + c0, rq);
      float bon_a = 0.f, bon_b = 0.f;   // sum_i r_j u_i k_j
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        bon_a = fmaf(ra[cc] * uu[cc], ka[cc], bon_a);
        bon_b = fmaf(rq[cc] * uu[cc], kq[cc], bon_b);
      }
      // (the 7 results stay in registers until the loop ends, so that no
      // store holds back the next steps' loads)
      const int s0 = HALF - 1 - jp;
      float hv[CPL], res[HALF - 1];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) hv[cc] = ka[cc];
#pragma unroll
      for (int s = 0; s < HALF - 1; ++s) {
        const int tau = s < s0 ? ja + 1 + s : s + 1;
        if (s == s0) {
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc) hv[cc] = kq[cc];
        }
        float rr[CPL], ww[CPL];
        load_bf16<CPL>(sr + rb(base) + c0 + tau * LDB, rr);
        load_f32<CPL>(sw + rw(base) + c0 + tau * LDW, ww);
        float part = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          part = fmaf(rr[cc], hv[cc], part);
          hv[cc] *= ww[cc];
        }
        res[s] = part;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        bon_a += __shfl_xor_sync(FULL, bon_a, o);
        bon_b += __shfl_xor_sync(FULL, bon_b, o);
#pragma unroll
        for (int s = 0; s < HALF - 1; ++s)
          res[s] += __shfl_xor_sync(FULL, res[s], o);
      }
      // every lane holds the sums: lane ig < 7 stores step ig's, lane 7
      // the two bonus terms
      float mine = res[0];
#pragma unroll
      for (int s = 1; s < HALF - 1; ++s) mine = ig == s ? res[s] : mine;
      if (ig < HALF - 1) {
        const int tau = ig < s0 ? ja + 1 + ig : ig + 1;
        const int j = ig < s0 ? ja : jb;
        put_split(at_hi, at_lo, (base + tau) * LDA + base + j, mine);
      } else {
        put_split(at_hi, at_lo, (base + ja) * LDA + base + ja, bon_a);
        put_split(at_hi, at_lo, (base + jb) * LDA + base + jb, bon_b);
      }
      if (ig < ja) put_split(at_hi, at_lo, (base + ig) * LDA + base + ja, 0.f);
      if (ig < jb) put_split(at_hi, at_lo, (base + ig) * LDA + base + jb, 0.f);
    }
    {
      // warps 0, 1: the off-diagonal block, att[16 + t, j] = r_hat_1[t] .
      // k_hat_0[j] for key tokens 8 warp ..; warps 2, 3: sub-chunk p's
      // square, att[16p + 8 + t, 16p + j] = r8[8p + t] . k8[8p + j] (rows
      // 8 p .. of the product), and the zeros above its diagonal block
      const bool sq = warp >= 2;
      const int p = warp & 1;
      const bf16* const ah_t = sq ? r8_hi : ro_hi;
      const bf16* const al_t = sq ? r8_lo : ro_lo;
      const bf16* const bh_t = sq ? k8_hi : ko_hi;
      const bf16* const bl_t = sq ? k8_lo : ko_lo;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
      float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        const int at = rb(mrow + 8 * (mat & 1)) + 16 * kk + 8 * (mat >> 1);
        ldsm_x4(ah_t + at, ah);
        ldsm_x4(al_t + at, al);
        const int bt = rb(HALF * p + mrow) + 16 * kk + 8 * (mat & 1);
        ldsm_x2(bh_t + bt, bh);
        ldsm_x2(bl_t + bt, bl);
        mma(x, ah, bl[0], bl[1]);
        mma(z, al, bh[0], bh[1]);
        mma(acc, ah, bh[0], bh[1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += x[q] + z[q];
      const bool up = sq && p;   // the square's rows are the product's 8..
      const int at1 = sq ? (SUB * p + HALF + g) * LDA + SUB * p + 2 * t4
                         : (SUB + g) * LDA + HALF * p + 2 * t4;
      const int at2 = sq ? (SUB * p + g) * LDA + SUB * p + HALF + 2 * t4
                         : at1 + 8 * LDA;
      store_split(at_hi, at_lo, at1, up ? acc[2] : acc[0],
                  up ? acc[3] : acc[1]);
      store_split(at_hi, at_lo, at2, sq ? 0.f : acc[2], sq ? 0.f : acc[3]);
    }
  }

  __syncthreads();   // the last chunk's att
  finish(nchunks - 1);
  __syncthreads();   // and its v are read

  // the final state, S[i][m], staged in the ring and written in rows
  cp_wait<0>();
  float* const sst = reinterpret_cast<float*>(smem);
  constexpr int LDS = N + 4;
  if (warp < N / 16) {
    const int m = 16 * warp + g;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int i = 8 * ni + 2 * t4;
      sst[i * LDS + m] = st[ni][0];
      sst[(i + 1) * LDS + m] = st[ni][1];
      sst[i * LDS + m + 8] = st[ni][2];
      sst[(i + 1) * LDS + m + 8] = st[ni][3];
    }
  }
  __syncthreads();
  float* const so = state + ((long long)b * H + h) * N * N;
  for (int e = tid; e < N * N / 4; e += THREADS) {
    const int row = e / (N / 4), q = e % (N / 4);
    *reinterpret_cast<float4*>(so + row * N + 4 * q) =
        *reinterpret_cast<const float4*>(sst + row * LDS + 4 * q);
  }
}

struct Args {
  const void *r, *k, *v;
  const float *logw, *u;
  float *y, *state;
  long long st[12];
  int B, S, H;
};

template <int N>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<N>::BYTES;
  // set on every call: the attributes belong to the current device
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_mma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rwkv6_mma_kernel<N>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long* st = a.st;
  rwkv6_mma_kernel<N><<<(unsigned)(a.B * a.H), THREADS, smem, stream>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.logw, a.u, a.y, a.state, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      a.S, a.H);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, seq, head) of r, then of k, v and logw.
extern "C" int rwkv6_mma_launch(
    const void* r, const void* k, const void* v, const float* logw,
    const float* u, float* y, float* state, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long w_sb,
    long long w_ss, long long w_sh, int B, int S, int H, int N,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, logw, u, y, state,
               {r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb,
                w_ss, w_sh},
               B, S, H};
  switch (N) {
    case 16: return launch<16>(a, stream);
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
