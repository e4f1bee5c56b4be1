// FlashAttention-2 forward on the CUDA cores: online softmax over kv tiles,
// causal and/or sliding-window masks, grouped-query heads, ragged lengths.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:96
// flash_attention_kernel (the Pallas body _attn_kernel at :36), together with
// the GQA expansion and (BH, S, d) transposes of its wrapper (ops.py:31-40).
//
// It computes what the Pallas kernel computes: q is scaled by 1/sqrt(d);
// scores, the running max m and sum l and the accumulator stay in float32;
// masked scores are NEG_INF = -1e30; kv tiles that the mask wholly excludes
// are skipped; the output is acc / max(l, 1e-30) in q's dtype.  Inputs are
// q (B, S, H, d) and k/v (B, Sk, KV, d), float32 or bfloat16, with any
// strides whose last dimension is contiguous; query head h reads kv head
// h / (H / KV).  The edge tiles of ragged S and Sk are masked here (keys past
// Sk score -inf, so they add nothing to m or l); the Pallas kernel asserts
// S % block == 0 instead.  d is 16, 32, 64, 96 or 128.
//
// What bounds it on the H100: operations.  Each unmasked (query, key) pair
// costs 2d multiply-adds (QK^T and PV), 4d flops: at the serving prefill
// (B 4, S 2048, H 40, KV 8, d 128, causal) that is 172 GFLOP, 0.17 ms at the
// tensor cores' 989 TFLOP/s in bf16, against 84 MB of q/k/v/o, 0.025 ms at
// 3.35 TB/s.  This kernel does not use the tensor cores: its dot products are
// float32 fused multiply-adds on the CUDA cores, whose peak is 67 TFLOP/s, so
// it cannot come within 15x of that bound.  mma.sync / wgmma on bf16 tiles
// and TMA loads are the next design's work.
//
// The simple design: one block of 128 threads per (batch, head, 64-row q
// tile), heaviest causal tiles launched first.  The block stages its q tile
// (scaled, float32) in shared memory once, then loops over 64-key tiles (the
// loop takes the place of the Pallas kv grid axis): it stages k and v as
// float32, each thread computes a 4 x 8 block of scores from float4 reads
// (rows padded by 4 floats so the reads hit distinct banks), reduces row max
// and sum across its 8 lanes with shuffles, writes its probabilities into
// the k buffer, and accumulates P V for 4 rows x d/8 columns in registers.
// Shared memory is 100 KB at d 128, so two blocks fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int RPT = 4;        // query rows per thread
constexpr int CPT = 8;        // key columns per thread: tx + 8 j
constexpr int LDP = BKV + 4;  // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static constexpr int LDQ = D + 4;                  // q/k row stride
  static constexpr int VEC = D >= 32 ? 4 : 2;        // P V columns per read
  static constexpr int NV = D / (8 * VEC);           // reads per row of v
  static constexpr int KP =                          // k tile, reused for P
      BKV * LDQ > BQ * LDP ? BKV * LDQ : BQ * LDP;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)(BQ * LDQ + KP + BKV * D);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_ss, long long o_sh, int S,
                       int Sk, int group, int causal, int window,
                       float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * L::LDQ;
  float* sP = sK;                 // probabilities overwrite the k tile
  float* sV = sK + L::KP;

  const int tid = threadIdx.x;
  const int tx = tid & 7;         // column lane: 8 lanes share 4 rows
  const int ty = tid >> 3;        // row group: rows RPT*ty .. RPT*ty+3
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, e = i - r * D;
    const int qpos = q0 + r;
    sQ[r * L::LDQ + e] =
        qpos < S ? to_f32(qb[(long long)qpos * q_ss + e]) * scale : 0.f;
  }

  int kt_end = (Sk + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BKV + 1);
  int kt_begin = 0;
  if (window > 0) {
    // a tile runs when its last key is inside the first row's window
    const int lo = q0 - window - BKV + 2;
    if (lo > 0) kt_begin = (lo + BKV - 1) / BKV;
  }

  float m[RPT], l[RPT], acc[RPT][D / 8];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the last tile's P V is done with sP and sV
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, e = i - r * D;
      const int kpos = k0 + r;
      const bool in = kpos < Sk;
      sK[r * L::LDQ + e] = in ? to_f32(kb[(long long)kpos * k_ss + e]) : 0.f;
      sV[r * D + e] = in ? to_f32(vb[(long long)kpos * v_ss + e]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float4 qa[RPT], ka[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            &sQ[(ty * RPT + i) * L::LDQ + e]);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ka[j] = *reinterpret_cast<const float4*>(
            &sK[(tx + 8 * j) * L::LDQ + e]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = s[i][j];
          a = __fmaf_rn(qa[i].x, ka[j].x, a);
          a = __fmaf_rn(qa[i].y, ka[j].y, a);
          a = __fmaf_rn(qa[i].z, ka[j].z, a);
          a = __fmaf_rn(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool keep = true;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        float x = keep ? s[i][j] : NEG_INF;
        x = kpos < Sk ? x : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading sK
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sP[(ty * RPT + i) * LDP + tx + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pa[i] = *reinterpret_cast<const float4*>(
            &sP[(ty * RPT + i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = sV + (c + cc) * D + tx * L::VEC;
#pragma unroll
        for (int jv = 0; jv < L::NV; ++jv) {
          float vv[L::VEC];
          if constexpr (L::VEC == 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + jv * 8 * L::VEC);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t =
                *reinterpret_cast<const float2*>(vrow + jv * 8 * L::VEC);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int e = 0; e < L::VEC; ++e)
              acc[i][jv * L::VEC + e] =
                  __fmaf_rn(p, vv[e], acc[i][jv * L::VEC + e]);
          }
        }
      }
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty * RPT + i;
    if (qpos >= S) continue;
    const float lg = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jv = 0; jv < L::NV; ++jv)
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) {
        const int col = jv * 8 * L::VEC + tx * L::VEC + e;
        store(&ob[(long long)qpos * o_ss + col], acc[i][jv * L::VEC + e] / lg);
      }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  long long st[12];  // (batch, seq, head) element strides of q, k, v, o
  int B, S, Sk, H, KV, causal, window;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::SMEM;
  // set on every call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long* st = a.st;
  const dim3 grid((unsigned)((a.S + BQ - 1) / BQ), (unsigned)a.H,
                  (unsigned)a.B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], a.S,
      a.Sk, a.H / a.KV, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 96: return launch<T, 96>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: (batch, seq, head) of q, then of k, v and o; the
// head dimension is contiguous.  dtype: 0 float32, 1 bfloat16.  window <= 0:
// no sliding window.  scale: 1/sqrt(D), rounded to float32 by the caller.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int B, int S, int Sk,
    int H, int KV, int D, int causal, int window, float scale, int dtype,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o,
               {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                o_ss, o_sh},
               B, S, Sk, H, KV, causal, window, scale};
  if (dtype == 0) return launch_d<float>(D, a, stream);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, a, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
