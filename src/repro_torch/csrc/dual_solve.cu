// Warm-started KL-dual solve, a group of threads per lane.
//
// Replaces: src/repro/kernels/dual_solve/kernel.py:93 dual_solve_warm_kernel
// (the Pallas tile body _dual_solve_tile at :41).
//
// Per lane: a 3-point scan of g(lam) = rho*lam + lam*LSE(log w + c/lam) at
// log lam +- half_width, the bracket around the smallest value (first index
// on ties), n_golden cached-point golden-section iterations, the clip of the
// bracket midpoint to log(span) +- 16, and g at that point (w.c when
// rho <= 0).  The op order is the Pallas tile's, written out per lane: the
// same hand-written LSE (m + log sum exp(x - m)), the same selects.  When
// the caller passes `dc`, the kernel also writes the envelope gradient
// d value / d c = softmax(log w + c / lam) at the returned lambda (w where
// rho <= 0), from the terms of its last g: the tuner's backward is then one
// multiply.
//
// What bounds it on the H100: neither bytes nor operations.  A lane reads
// 2n+2 floats and writes 2 (n more with dc); at the tuner's L = 9,600 lanes
// that is ~0.4 MB, about 0.1 us at 3.35 TB/s, and 12 g-evaluations of ~5n
// transcendentals each.  Above the launch floor, the time is the latency of
// a lane's chain of dependent evaluations.
//
// The design: a group of G threads a lane (kGroupSmall = 4 threads for
// n <= 4, the tuner's cost vectors, and kGroupLarge = 16 for n <= 16), 128
// threads a block, so the tuner's 9,600 lanes x 4 make 300 blocks, two to
// three an SM.  Thread i of a group holds component i's c, log w and w.
// Wider vectors (the kernels suite's 64 costs a lane) take the large group
// with P = kPartsWide = 4 components a thread for n <= 64: thread i holds
// components i*P .. i*P + P-1, takes their max before the group's, and the
// sum still adds the n terms in index order; at P = 1 every loop over a
// thread's components is the single component above.
// An evaluation forms x_i = log w_i + c_i / lam (a true division) and
// exp(x_i - m) on each thread; the max comes by butterfly shuffles within
// the group (exact in any order) and the sum by gathering the n terms on
// every thread and adding them in index order, as the one-thread design
// did: the golden section's compares flip on a 1-ulp difference, so the
// order of the sum is kept.  Every thread of a group then holds the same g
// and takes the same branch.  Evaluations that do not depend on each other
// run side by side, interleaved in one pass: the scan's points (3 at a
// time), then a0 and b0, then each golden step's new point beside the two
// points the next step may need (one for each outcome of the compare that
// waits on it: the pass resolves two steps).  The last step's new point is
// never read (the returned bracket is fixed by its compare), so its pass
// holds the final g at each outcome's lambda instead.  At n_golden = 6 the
// chain is scan, (a0, b0) and three passes of 3: 5 passes where the
// one-thread design had 12 evaluations in a row.  Each g is the one-thread
// design's, op for op (built without FMA contraction or fast math), at the
// same points, so on every lane the value and log lambda are bit for bit
// those of the one-thread design.  A group never straddles a warp's half (G
// divides 16), and every shuffle names only its group's threads, so a warp
// whose last groups lie past L (they return at once) does not wait on them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kGR = 0.6180339887498949f;   // golden ratio conjugate
constexpr int kGroupSmall = 4;               // threads a lane, n <= 4
constexpr int kGroupLarge = 16;              // threads a lane, n <= 16
constexpr int kPartsWide = 4;                // components a thread, n <= 64
constexpr int kThreads = 128;
constexpr int kScanWidth = 3;                // scan points evaluated at once

// One lane's P components, held by one thread of its group.
template <int G, int P>
struct Part {
  float c[P], logw[P], w[P];
  bool on[P];       // the component exists (its index < n)
  int n;
  float rho;
  unsigned mask;    // the group's threads in the warp

  // g at each of the K log lambdas in ll, side by side; every thread of the
  // group returns the same K values.  With e, also each lambda's
  // exp(x_i - m) and the sum of the terms (for the envelope gradient).
  template <int K>
  __device__ void g(const float (&ll)[K], float (&out)[K],
                    float (*e_out)[K][P] = nullptr,
                    float (*s_out)[K] = nullptr) const {
    float lam[K], x[K][P], m[K], e[K][P], s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lam[k] = fmaxf(expf(ll[k]), 1e-12f);
#pragma unroll
      for (int q = 0; q < P; ++q)
        x[k][q] = on[q] ? logw[q] + c[q] / lam[k] : -INFINITY;
      m[k] = x[k][0];
#pragma unroll
      for (int q = 1; q < P; ++q) m[k] = fmaxf(m[k], x[k][q]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        m[k] = fmaxf(m[k], __shfl_xor_sync(mask, m[k], off, G));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int q = 0; q < P; ++q) e[k][q] = expf(x[k][q] - m[k]);
      s[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float t = __shfl_sync(mask, e[k][q], i, G);
          if (i * P + q < n) s[k] += t;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k] = rho * lam[k] + lam[k] * (m[k] + logf(s[k]));
    if (e_out != nullptr) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int q = 0; q < P; ++q) (*e_out)[k][q] = e[k][q];
        (*s_out)[k] = s[k];
      }
    }
  }

  // The sum over the group of the components' v, in index order from 0.
  __device__ float sum_in_order(const float (&v)[P]) const {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float t = __shfl_sync(mask, v[q], i, G);
        if (i * P + q < n) s += t;
      }
    }
    return s;
  }

  __device__ float group_max(float v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(mask, v, off, G));
    return v;
  }

  __device__ float group_min(float v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(mask, v, off, G));
    return v;
  }
};

// One golden-section step from the bracket (lo, hi) and its points (a, b),
// by the compare `smaller` = g(a) < g(b): the new bracket and points, and
// the point p whose g the step needs.
struct Step {
  float lo, hi, a, b, p;
};

__device__ __forceinline__ Step step(float llo, float lhi, float a, float b,
                                     bool smaller) {
  Step s;
  s.lo = smaller ? llo : a;
  s.hi = smaller ? b : lhi;
  s.a = smaller ? s.hi - kGR * (s.hi - s.lo) : b;
  s.b = smaller ? a : s.lo + kGR * (s.hi - s.lo);
  s.p = smaller ? s.a : s.b;
  return s;
}

// The returned log lambda: the bracket's midpoint clipped to
// log(span) +- 16.
__device__ __forceinline__ float clip_mid(float llo, float lhi, float lspan) {
  return fminf(fmaxf(0.5f * (llo + lhi), lspan - 16.0f), lspan + 16.0f);
}

// offs = linspace(-half_width, half_width, n_local) in float32, as
// jnp.linspace forms it: start * (1 - t) + stop * t, t = j / (n_local - 1)
__device__ __forceinline__ float offset(int j, int n_local, float hw) {
  const float t = n_local > 1 ? (float)j / (float)(n_local - 1) : 0.0f;
  return -hw * (1.0f - t) + hw * t;
}

template <int G, int P>
__global__ void __launch_bounds__(kThreads) dual_solve_warm_kernel(
    const float* __restrict__ C, const float* __restrict__ W,
    long long w_stride, const float* __restrict__ rho_in,
    const float* __restrict__ llam_in, float* __restrict__ val_out,
    float* __restrict__ lnew_out, float* __restrict__ dc_out, long long L,
    int n, float half_width, int n_local, int n_golden) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = tid / G;
  if (lane >= L) return;                 // the whole group returns
  const int sub = (int)(tid % G);
  const int warp_lane = threadIdx.x & 31;

  Part<G, P> p;
  p.mask = ((1u << G) - 1u) << (warp_lane & ~(G - 1));
  p.n = n;
  p.rho = rho_in[lane];
  float cmax = -INFINITY, cmin = INFINITY;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = sub * P + q;
    p.on[q] = i < n;
    p.c[q] = p.on[q] ? C[lane * n + i] : 0.0f;
    p.w[q] = p.on[q] ? W[lane * w_stride + i] : 0.0f;
    p.logw[q] = logf(p.w[q]);
    cmax = fmaxf(cmax, p.on[q] ? p.c[q] : -INFINITY);
    cmin = fminf(cmin, p.on[q] ? p.c[q] : INFINITY);
  }
  cmax = p.group_max(cmax);
  cmin = p.group_min(cmin);
  const float llam = llam_in[lane];

  // local scan + bracket (argmin keeps the first index on ties); the
  // scan's points kScanWidth at a time, a pass's spare points at j = 0
  int best = 0;
  float best_v = 0.0f;
  for (int j0 = 0; j0 < n_local; j0 += kScanWidth) {
    float ll[kScanWidth], v[kScanWidth];
#pragma unroll
    for (int k = 0; k < kScanWidth; ++k) {
      const int j = j0 + k < n_local ? j0 + k : 0;
      ll[k] = llam + offset(j, n_local, half_width);
    }
    p.g(ll, v);
#pragma unroll
    for (int k = 0; k < kScanWidth; ++k) {
      const int j = j0 + k;
      if (j == 0) {
        best_v = v[k];
      } else if (j < n_local && v[k] < best_v) {
        best_v = v[k];
        best = j;
      }
    }
  }
  const int jlo = best > 0 ? best - 1 : 0;
  const int jhi = best + 1 < n_local ? best + 1 : n_local - 1;
  float llo = llam + offset(jlo, n_local, half_width);
  float lhi = llam + offset(jhi, n_local, half_width);

  // cached-point golden section: a0 and b0 side by side; then each
  // evaluation runs beside the two candidates of the next (one for each
  // outcome of the compare that waits on it), so two steps cost one pass
  float a = lhi - kGR * (lhi - llo);
  float b = llo + kGR * (lhi - llo);
  float fa, fb;
  {
    const float ab[2] = {a, b};
    float f[2];
    p.g(ab, f);
    fa = f[0];
    fb = f[1];
  }
  const float lspan = logf(fmaxf(cmax - cmin, 1e-9f));
  bool have_final = false;       // the final g came with the last pass
  float g_final = 0.0f, e_final[P] = {}, s_final = 0.0f;
  int it = 0;
  while (it < n_golden) {
    const bool smaller = fa < fb;
    Step s1 = step(llo, lhi, a, b, smaller);
    ++it;
    if (it == n_golden) {        // the new point's g is never read
      llo = s1.lo, lhi = s1.hi;
      break;
    }
    const Step s2[2] = {step(s1.lo, s1.hi, s1.a, s1.b, true),
                        step(s1.lo, s1.hi, s1.a, s1.b, false)};
    // the last step's point is never evaluated: its pass holds the final
    // g at each outcome's lambda instead
    const bool last = it + 1 == n_golden;
    const float at[3] = {
        s1.p, last ? clip_mid(s2[0].lo, s2[0].hi, lspan) : s2[0].p,
        last ? clip_mid(s2[1].lo, s2[1].hi, lspan) : s2[1].p};
    float f[3], e[3][P], s[3];
    p.g(at, f, &e, &s);
    const float nfa = smaller ? f[0] : fb;
    const float nfb = smaller ? fa : f[0];
    const bool smaller2 = nfa < nfb;
    const int o = smaller2 ? 0 : 1;
    ++it;
    llo = s2[o].lo, lhi = s2[o].hi, a = s2[o].a, b = s2[o].b;
    if (last) {
      have_final = true;
      g_final = f[1 + o], s_final = s[1 + o];
#pragma unroll
      for (int q = 0; q < P; ++q) e_final[q] = e[1 + o][q];
      break;
    }
    fa = smaller2 ? f[1 + o] : nfb;
    fb = smaller2 ? nfa : f[1 + o];
  }

  const float lnew = clip_mid(llo, lhi, lspan);
  float val, dc[P];
  if (p.rho <= 0.0f) {
    float wc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) wc[q] = p.w[q] * p.c[q];
    val = p.sum_in_order(wc);
#pragma unroll
    for (int q = 0; q < P; ++q) dc[q] = p.w[q];
  } else {
    if (!have_final) {
      const float at[1] = {lnew};
      float f[1], e[1][P], s[1];
      p.g(at, f, &e, &s);
      g_final = f[0], s_final = s[0];
#pragma unroll
      for (int q = 0; q < P; ++q) e_final[q] = e[0][q];
    }
    val = g_final;
#pragma unroll
    for (int q = 0; q < P; ++q) dc[q] = e_final[q] / s_final;
  }
  if (sub == 0) {
    val_out[lane] = val;
    lnew_out[lane] = lnew;
  }
  if (dc_out != nullptr) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (p.on[q]) dc_out[lane * n + sub * P + q] = dc[q];
  }
}

template <int G, int P = 1>
void launch_group(const float* C, const float* W, long long w_stride,
                  const float* rho, const float* llam, float* val,
                  float* lnew, float* dc, long long L, int n,
                  float half_width, int n_local, int n_golden,
                  cudaStream_t stream) {
  const long long threads = L * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  dual_solve_warm_kernel<G, P><<<blocks, kThreads, 0, stream>>>(
      C, W, w_stride, rho, llam, val, lnew, dc, L, n, half_width, n_local,
      n_golden);
}

}  // namespace

// dc may be null (no gradient); n lies in [1, kGroupLarge * kPartsWide]:
// the wrapper checks.
extern "C" int dual_solve_warm_launch(const float* C, const float* W,
                                      long long w_stride, const float* rho,
                                      const float* llam, float* val,
                                      float* lnew, float* dc, long long L,
                                      int n, float half_width, int n_local,
                                      int n_golden, cudaStream_t stream) {
  if (L <= 0) return 0;
  if (n < 1 || n > kGroupLarge * kPartsWide || n_local < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= kGroupSmall) {
    launch_group<kGroupSmall>(C, W, w_stride, rho, llam, val, lnew, dc, L, n,
                              half_width, n_local, n_golden, stream);
  } else if (n <= kGroupLarge) {
    launch_group<kGroupLarge>(C, W, w_stride, rho, llam, val, lnew, dc, L, n,
                              half_width, n_local, n_golden, stream);
  } else {
    launch_group<kGroupLarge, kPartsWide>(C, W, w_stride, rho, llam, val,
                                          lnew, dc, L, n, half_width,
                                          n_local, n_golden, stream);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
