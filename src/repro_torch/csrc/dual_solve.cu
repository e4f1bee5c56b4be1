// Warm-started KL-dual solve, one thread per lane.
//
// Replaces: src/repro/kernels/dual_solve/kernel.py:93 dual_solve_warm_kernel
// (the Pallas tile body _dual_solve_tile at :41).
//
// Per lane: a 3-point scan of g(lam) = rho*lam + lam*LSE(log w + c/lam) at
// log lam +- half_width, the bracket around the smallest value (first index
// on ties), n_golden cached-point golden-section iterations, the clip of the
// bracket midpoint to log(span) +- 16, and g at that point (w.c when
// rho <= 0).  The op order is the Pallas tile's, written out per lane:
// the same hand-written LSE (m + log sum exp(x - m)), the same selects.
//
// What bounds it on the H100: neither bytes nor operations.  A lane reads
// 2n+2 floats and writes 2; at the tuner's L = 9,600 lanes that is ~0.4 MB,
// about 0.1 us at 3.35 TB/s, and 12 g-evaluations of ~5n transcendentals
// each, ~2.3 M in all.  One launch is below the card's launch floor of a few
// microseconds, so the launch itself bounds it.
//
// The simple design: one thread per lane, everything in registers (n is a
// template bound of 4 for the tuner's cost vectors), 128 threads per block,
// no shared memory, no synchronisation.  Nothing to tile: lanes are
// independent and each thread's working set is a few dozen registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kGR = 0.6180339887498949f;   // golden ratio conjugate

template <int NMAX>
struct Lane {
  float c[NMAX];
  float logw[NMAX];
  int n;
  float rho;

  __device__ float g(float ll) const {
    const float lam = fmaxf(expf(ll), 1e-12f);
    float x[NMAX];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) {
        x[i] = logw[i] + c[i] / lam;
        m = fmaxf(m, x[i]);
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) s += expf(x[i] - m);
    }
    return rho * lam + lam * (m + logf(s));
  }
};

// offs = linspace(-half_width, half_width, n_local) in float32, as
// jnp.linspace forms it: start * (1 - t) + stop * t, t = j / (n_local - 1)
__device__ __forceinline__ float offset(int j, int n_local, float hw) {
  const float t = n_local > 1 ? (float)j / (float)(n_local - 1) : 0.0f;
  return -hw * (1.0f - t) + hw * t;
}

template <int NMAX>
__global__ void dual_solve_warm_kernel(
    const float* __restrict__ C, const float* __restrict__ W,
    long long w_stride, const float* __restrict__ rho_in,
    const float* __restrict__ llam_in, float* __restrict__ val_out,
    float* __restrict__ lnew_out, long long L, int n, float half_width,
    int n_local, int n_golden) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  Lane<NMAX> p;
  p.n = n;
  p.rho = rho_in[lane];
  float w[NMAX];
  float cmax = -INFINITY, cmin = INFINITY;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i < n) {
      p.c[i] = C[lane * n + i];
      w[i] = W[lane * w_stride + i];
      p.logw[i] = logf(w[i]);
      cmax = fmaxf(cmax, p.c[i]);
      cmin = fminf(cmin, p.c[i]);
    }
  }
  const float llam = llam_in[lane];

  // local scan + bracket (argmin keeps the first index on ties)
  int best = 0;
  float best_v = p.g(llam + offset(0, n_local, half_width));
  for (int j = 1; j < n_local; ++j) {
    const float v = p.g(llam + offset(j, n_local, half_width));
    if (v < best_v) {
      best_v = v;
      best = j;
    }
  }
  const int jlo = best > 0 ? best - 1 : 0;
  const int jhi = best + 1 < n_local ? best + 1 : n_local - 1;
  float llo = llam + offset(jlo, n_local, half_width);
  float lhi = llam + offset(jhi, n_local, half_width);

  // cached-point golden section: one new g per iteration
  float a = lhi - kGR * (lhi - llo);
  float b = llo + kGR * (lhi - llo);
  float fa = p.g(a);
  float fb = p.g(b);
  for (int it = 0; it < n_golden; ++it) {
    const bool smaller = fa < fb;
    const float nlo = smaller ? llo : a;
    const float nhi = smaller ? b : lhi;
    const float na = smaller ? nhi - kGR * (nhi - nlo) : b;
    const float nb = smaller ? a : nlo + kGR * (nhi - nlo);
    const float fnew = p.g(smaller ? na : nb);
    const float nfa = smaller ? fnew : fb;
    const float nfb = smaller ? fa : fnew;
    llo = nlo;
    lhi = nhi;
    a = na;
    b = nb;
    fa = nfa;
    fb = nfb;
  }

  const float lspan = logf(fmaxf(cmax - cmin, 1e-9f));
  const float lnew =
      fminf(fmaxf(0.5f * (llo + lhi), lspan - 16.0f), lspan + 16.0f);
  float val;
  if (p.rho <= 0.0f) {
    val = 0.0f;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) val += w[i] * p.c[i];
    }
  } else {
    val = p.g(lnew);
  }
  val_out[lane] = val;
  lnew_out[lane] = lnew;
}

}  // namespace

extern "C" int dual_solve_warm_launch(const float* C, const float* W,
                                      long long w_stride, const float* rho,
                                      const float* llam, float* val,
                                      float* lnew, long long L, int n,
                                      float half_width, int n_local,
                                      int n_golden, cudaStream_t stream) {
  if (L <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((L + threads - 1) / threads);
  if (n <= 4) {
    dual_solve_warm_kernel<4><<<blocks, threads, 0, stream>>>(
        C, W, w_stride, rho, llam, val, lnew, L, n, half_width, n_local,
        n_golden);
  } else {
    dual_solve_warm_kernel<16><<<blocks, threads, 0, stream>>>(
        C, W, w_stride, rho, llam, val, lnew, L, n, half_width, n_local,
        n_golden);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
