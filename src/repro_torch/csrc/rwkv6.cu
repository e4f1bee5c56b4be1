// RWKV-6 WKV recurrence, forward, in float32: y and the final state, per
// (batch, head).
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:74 rwkv6_kernel (the Pallas
// body _wkv_kernel at :28), together with the (BH, S, n) transposes and the
// tile of u that its wrapper (ops.py:18-24) makes, for float32 r/k/v.
// bfloat16 r/k/v go to rwkv6_mma.cu, the chunked form on the tensor cores:
// only this per-step form holds the float32 contract (5e-4) over 2048
// slow-decay steps, since the tensor cores multiply at most 16-bit
// operand halves.
//
// It computes the contract of the Pallas kernel, ref.py::wkv_ref, the
// per-step recurrence on an n x n float32 state S (S_0 = 0):
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//
// r/k/v and logw are (B, S, H, n) float32,
// each with any strides whose last dimension is contiguous; u is (H, n)
// float32, contiguous.  Outputs: y (B, S, H, n) float32 and the final state
// (B, H, n, n) float32, both contiguous.  n is 16, 32 or 64.  The Pallas
// kernel's chunked matmul form (pairwise log-space decays inside a chunk of
// 32, a carried state across chunks) is a TPU adaptation that feeds the MXU;
// the per-step form here needs no exponent but exp(logw) <= 1, so nothing
// can overflow, and it forms each term r_i (S_im + u_i k_i v_m) as the
// reference does (the sums over i run in another order).
//
// What bounds it on the H100: bytes.  At the rwkv6-3b prefill's shape (B 4,
// S 2048, H 40, n 64) in float32 the function moves 422 MB (r/k/v, logw and
// y 84 MB each, the state 2.6 MB): 0.126 ms at 3.35 TB/s, against 4n^2 =
// 16,384 flops per token and head, 5.4 GFLOP, 0.080 ms at the float32
// CUDA-core peak of 67 TFLOP/s.  This design cannot reach either: the steps
// of one (batch, head) run in order, so a block's time is its steps times
// the cycles of one step.  Two things set those cycles (measured on the
// H100 with variants of this kernel): the SM's shared-memory pipe, which
// serves one 128-byte wavefront a cycle and charges a warp one wavefront
// for each float every lane reads, broadcast or not (so every value column
// that reads r, k and exp(logw) again costs as much as the first); and the
// warps an SM has to interleave, since one warp alone cannot issue every
// cycle.
//
// The design: each thread owns a 4 x 4 tile of the state in registers, 4
// rows i by 4 value columns m, so each float4 of r, k and exp(logw) it reads
// from shared memory serves 4 columns and each float4 of v serves 4 rows.
// A block holds the n/4 row groups of up to 32 value columns (the columns
// of the state are independent: y_t[m] and S[:, m] read only v[:, m]), so a
// (batch, head) with n = 64 takes two blocks and the serving prefill has
// 320 blocks of 128 threads.  Per step a thread writes the 4 partial sums of
// y_t over its rows to shared memory; at the end of each chunk of TS steps
// the block sums the n/4 partials of every (step, column) and writes y in
// whole rows.  r, k, exp(logw) and v are staged TS steps at a time; the
// next TS steps are loaded into registers, raw, while the current ones are
// computed.  Partial rows are padded by 4 floats so that one quarter-warp's
// float4 writes fall in distinct banks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TS = 16;   // steps staged in shared memory at a time
constexpr int TILE = 4;  // state rows and value columns per thread

template <int N>
struct Layout {
  static constexpr int RG = N / TILE;            // row groups
  static constexpr int NC = N < 32 ? N : 32;     // value columns per block
  static constexpr int CS = N / NC;              // blocks per (batch, head)
  static constexpr int THREADS = RG * (NC / TILE);
  static constexpr int STEP = THREADS / N;       // r/k/w: steps per load
  static constexpr int PER = TS * N / THREADS;   // r/k/w: loads per thread
  static constexpr int STEPV = THREADS / NC;     // v: steps per load
  static constexpr int PERV = TS * NC / THREADS; // v: loads per thread
  static constexpr int YP = NC + 4;              // padded row of partials
  static constexpr int SMEM_FLOATS = 3 * TS * N + TS * NC + TS * RG * YP;
  static_assert(THREADS % N == 0 && THREADS % NC == 0, "layout");
};

template <int N>
__global__ void __launch_bounds__(Layout<N>::THREADS)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ logw,
             const float* __restrict__ u, float* __restrict__ y,
             float* __restrict__ state, long long r_sb, long long r_ss,
             long long r_sh, long long k_sb, long long k_ss, long long k_sh,
             long long v_sb, long long v_ss, long long v_sh, long long w_sb,
             long long w_ss, long long w_sh, int S, int H) {
  using L = Layout<N>;
  constexpr int RG = L::RG, NC = L::NC, THREADS = L::THREADS;
  constexpr int STEP = L::STEP, PER = L::PER, STEPV = L::STEPV;
  constexpr int PERV = L::PERV, YP = L::YP;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                 // [TS][N] r
  float* sk = sr + TS * N;          // [TS][N] k
  float* sw = sk + TS * N;          // [TS][N] exp(logw)
  float* sv = sw + TS * N;          // [TS][NC] v of this block's columns
  float* sy = sv + TS * NC;         // [TS][RG][YP] partial sums of y

  const int tid = threadIdx.x;
  const int g = tid % RG;           // rows 4g .. 4g + 3
  const int m0 = (tid / RG) * TILE; // columns c0 + m0 .. c0 + m0 + 3
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int c0 = blockIdx.y * NC;
  // Staging: a chunk's element e = tid + q*THREADS of r/k/w is step
  // tid/N + STEP*q, column tid%N (of v: the same over NC columns), so
  // neighbouring threads read neighbouring columns of one step.
  const int t_rk = tid / N, c_rk = tid % N;
  const int t_v = tid / NC, c_v = tid % NC;
  const float* rb = r + b * r_sb + h * r_sh + c_rk;
  const float* kb = k + b * k_sb + h * k_sh + c_rk;
  const float* wb = logw + b * w_sb + h * w_sh + c_rk;
  const float* vb = v + b * v_sb + h * v_sh + c0 + c_v;
  float* yb = y + ((long long)b * S * H + h) * N + c0;

  float st[TILE][TILE], uu[TILE];   // st[row][column]
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    uu[i] = u[h * N + g * TILE + i];
#pragma unroll
    for (int c = 0; c < TILE; ++c) st[i][c] = 0.f;
  }

  // The next chunk's values, held raw until they are staged: nothing reads
  // them before then, so the loads stay in flight through a whole chunk of
  // steps.  Steps past S load row S - 1 (a branch around the load, or a
  // use of its value here, would make each load wait for memory); they are
  // staged but never read.
  float pr[PER], pk[PER], pv[PERV], pw[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const long long t = min(t0 + t_rk + STEP * q, S - 1);
      pr[q] = rb[t * r_ss];
      pk[q] = kb[t * k_ss];
      pw[q] = wb[t * w_ss];
    }
#pragma unroll
    for (int q = 0; q < PERV; ++q) {
      const long long t = min(t0 + t_v + STEPV * q, S - 1);
      pv[q] = vb[t * v_ss];
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TS) {
    __syncthreads();             // the previous chunk is no longer read
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int p = (t_rk + STEP * q) * N + c_rk;
      sr[p] = pr[q];
      sk[p] = pk[q];
      sw[p] = expf(pw[q]);
    }
#pragma unroll
    for (int q = 0; q < PERV; ++q)
      sv[(t_v + STEPV * q) * NC + c_v] = pv[q];
    __syncthreads();
    if (t0 + TS < S) fetch(t0 + TS);   // in flight while this chunk runs

    const int steps = min(TS, S - t0);
    for (int s = 0; s < steps; ++s) {
      const float4 r4 = *reinterpret_cast<const float4*>(sr + s * N + 4 * g);
      const float4 k4 = *reinterpret_cast<const float4*>(sk + s * N + 4 * g);
      const float4 w4 = *reinterpret_cast<const float4*>(sw + s * N + 4 * g);
      const float4 v4 = *reinterpret_cast<const float4*>(sv + s * NC + m0);
      const float rr[TILE] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[TILE] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[TILE] = {w4.x, w4.y, w4.z, w4.w};
      const float vm[TILE] = {v4.x, v4.y, v4.z, v4.w};
      float acc[TILE];
#pragma unroll
      for (int c = 0; c < TILE; ++c) {
        acc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < TILE; ++i) {
          const float a = kk[i] * vm[c];                 // k_i v_m
          acc[c] = fmaf(rr[i], fmaf(uu[i], a, st[i][c]), acc[c]);
          st[i][c] = fmaf(st[i][c], ww[i], a);
        }
      }
      *reinterpret_cast<float4*>(sy + (s * RG + g) * YP + m0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();             // every partial of this chunk is written
    for (int o = tid; o < steps * NC; o += THREADS) {
      const int s = o / NC, m = o % NC;
      float yt = 0.f;
#pragma unroll
      for (int gg = 0; gg < RG; ++gg) yt += sy[(s * RG + gg) * YP + m];
      yb[(long long)(t0 + s) * H * N + m] = yt;
    }
  }

  float* so = state + ((long long)b * H + h) * N * N + c0 + m0;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    *reinterpret_cast<float4*>(so + (g * TILE + i) * N) =
        make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
  }
}

struct Args {
  const float *r, *k, *v, *logw, *u;
  float *y, *state;
  long long st[12];
  int B, S, H;
};

template <int N>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<N>;
  constexpr size_t smem = sizeof(float) * L::SMEM_FLOATS;
  // set on every call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long* st = a.st;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)L::CS);
  rwkv6_kernel<N><<<grid, L::THREADS, smem, stream>>>(
      a.r, a.k, a.v, a.logw, a.u, a.y, a.state, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      a.S, a.H);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, seq, head) of r, then of k, v and logw;
// the last dimension is contiguous.
extern "C" int rwkv6_launch(
    const float* r, const float* k, const float* v, const float* logw,
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
