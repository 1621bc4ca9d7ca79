// The mip-NeRF level resampler: blurpool of the level's weights, the
// padding, and the hardened inverse CDF over the fenceposts, one kernel.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/pdf_merge.py::
// mip_resample_t_vals. Input per ray: fenceposts t [S + 1] ascending,
// weights w [S], ascending draws u [S + 1] in [0, 1), fp32, S + 1 <= 128,
// each row read through its row stride (0 hands every ray the same row, as
// the deterministic draws do), its last dimension unit-stride; the padding
// is a scalar argument. Output: the new fenceposts [S + 1]. The function
// is core/sampling.py::resample_along_rays without the cone casting
// (RegNeRF mip.py:349-403, math.py:169-234):
//   blur_i = 0.5 (max(w_{i-1}, w_i) + max(w_i, w_{i+1})), edges duplicated;
//   w' = blur + padding, then + max(0, eps - sum w') on every weight;
//   pdf = w' / sum w'; cdf = [0, min(1, cumsum(pdf[:-1])), 1];
//   per draw the interval cdf_k <= u < cdf_{k+1},
//   t = clip((u - cdf_k) / (cdf_{k+1} - cdf_k), 0, 1) (0 where 0 / 0),
//   t' = t_k + t (t_{k+1} - t_k).
//
// Bound: bytes, 1,548 bytes a ray at S = 96 (t 388, w 384, u 388 in, t'
// 388 out) for ~1k operations, so an 8192-ray chunk needs at least 3.8 us
// at 3.35 TB/s. Design, as pdf_merge.cu's: a group of G = 16 lanes a ray
// (two rays a warp), every load issued first, the fenceposts and the cdf
// in shared memory.
// Lane l holds the weights [l E, l E + E), E = ceil(S / G), in registers
// and takes its neighbours' edge weights by shuffles for the blur; both
// sums are butterflies (__shfl_xor_sync, the same bits in every lane),
// each lane divides its own entries, and the cdf is the lane's serial
// prefix plus a log-step __shfl_up_sync scan of the lane totals, clamped
// to 1 after the scan. Lane l takes the draws l + G k (coalesced) and
// finds their intervals by branchless binary searches that take each step
// together (their loads overlap). Rounds as the
// plain PyTorch version (no fused multiply-add), though its sums take
// another order; no atomics, and a second launch gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 128;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr int G = 16;  // lanes a ray: two rays a warp

// lo[e] = #{i < n: a[i] <= x[e]} for the ascending a[0, n), 1 <= n <=
// 128, top the largest power of two <= n, the N searches a step at a time
// (as pdf_merge.cu's count_below).
template <int N>
__device__ __forceinline__ void count_le(const float* a, int n, int top,
                                         const float (&x)[N], int (&lo)[N]) {
  const float y = a[top - 1];
#pragma unroll
  for (int e = 0; e < N; ++e) lo[e] = y <= x[e] ? n - top + 1 : 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1)
    if (step < top) {
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (a[lo[e] + step - 1] <= x[e]) lo[e] += step;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kAll, v, off, G));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    mip_resample_kernel(const float* __restrict__ t, int ldt,
                        const float* __restrict__ w, int ldw,
                        const float* __restrict__ u, int ldu,
                        float* __restrict__ out, int n, int s,
                        float padding) {
  constexpr int kE = kMax / G;  // register entries a lane
  // The rows of a ray, 2 kMax + 4 floats apart, so that the two rays of
  // a warp at G = 16 probe the same index in other banks.
  __shared__ __align__(16) float s_rows[kThreads / G][2 * kMax + 4];
  const int sub = threadIdx.x % G, slot = threadIdx.x / G;
  const int ray = blockIdx.x * (kThreads / G) + slot;
  // A group past the last ray works on the last one and stores nothing,
  // so every lane of a warp reaches the shuffles.
  const bool valid = ray < n;
  const size_t r = valid ? ray : n - 1;
  float* tv = s_rows[slot];
  float* cdf = tv + kMax;

  // Every load first: weights and draws into registers, the fenceposts
  // into shared memory.
  const float* wr = w + r * ldw;
  const float* ur = u + r * ldu;
  const int e_n = (s + G - 1) / G, i0 = sub * e_n;
  float wv[kE], b[kE], x[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e)
    wv[e] = e < e_n && i0 + e < s ? __ldg(wr + i0 + e) : 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e)  // slots past the row search for 0
    x[e] = sub + G * e <= s ? __ldg(ur + sub + G * e) : 0.f;
  const float* tr = t + r * ldt;
  for (int i = sub; i <= s; i += G) tv[i] = __ldg(tr + i);

  // Blur: lane-held weights, the neighbours' edge weights by shuffles.
  float last = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < e_n) last = wv[e];
  const float left = __shfl_up_sync(kAll, last, 1, G);
  const float right = __shfl_down_sync(kAll, wv[0], 1, G);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = i0 + e;
    b[e] = 0.f;
    if (e < e_n && i < s) {
      const float wl = i == 0   ? wv[e]
                       : e == 0 ? left
                                : wv[e > 0 ? e - 1 : 0];
      const float wn = i == s - 1       ? wv[e]
                       : e == e_n - 1 ? right
                                        : wv[e + 1 < kE ? e + 1 : e];
      b[e] = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(fmaxf(wl, wv[e]),
                                                 fmaxf(wv[e], wn))),
                       padding);
    }
    sum = __fadd_rn(sum, b[e]);
  }
  sum = warp_sum(sum);
  const float pad = fmaxf(__fsub_rn(kEps, sum), 0.f);
  // Where no ray of the warp is under eps, every pad is 0 and the sum of
  // the padded weights is the sum's bits.
  float sum2 = sum;
  if (__any_sync(kAll, pad > 0.f)) {
    sum2 = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e < e_n && i0 + e < s) b[e] = __fadd_rn(b[e], pad);
      sum2 = __fadd_rn(sum2, b[e]);
    }
    sum2 = warp_sum(sum2);
  }

  // cdf[i + 1] = min(1, pdf_0 + ... + pdf_i) for i < S - 1.
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < e_n && i0 + e < s - 1) {
      run = __fadd_rn(run, __fdiv_rn(b[e], sum2));
      b[e] = run;
    }
  float incl = run;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float y = __shfl_up_sync(kAll, incl, off, G);
    if (sub >= off) incl = __fadd_rn(incl, y);
  }
  float base = __shfl_up_sync(kAll, incl, 1, G);
  if (sub == 0) {
    base = 0.f;
    cdf[0] = 0.f;
    cdf[s] = 1.f;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < e_n && i0 + e < s - 1)
      cdf[i0 + e + 1] = fminf(__fadd_rn(base, b[e]), 1.f);
  __syncwarp();
  if (!valid) return;  // nothing below synchronises

  // The draws l + G k: interval, clipped interpolation.
  float* orow = out + r * (s + 1);
  int idx[kE];
  count_le(cdf, s + 1, 1 << (31 - __clz(s + 1)), x, idx);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int k0 = max(idx[e] - 1, 0), k1 = min(idx[e], s);
    const float c0 = cdf[k0], c1 = cdf[k1];
    float f = __fdiv_rn(__fsub_rn(x[e], c0), __fsub_rn(c1, c0));
    if (f != f) f = 0.f;  // 0 / 0
    f = fminf(fmaxf(f, 0.f), 1.f);
    if (sub + G * e <= s)
      orow[sub + G * e] =
          __fadd_rn(tv[k0], __fmul_rn(f, __fsub_rn(tv[k1], tv[k0])));
  }
}

}  // namespace

// t: [n, s + 1], row stride ldt; w: [n, s], row stride ldw; u: [n, s + 1]
// ascending in [0, 1), row stride ldu (0: one row for every ray); each row
// unit-stride. out: [n, s + 1], contiguous. All fp32; 1 <= s, s + 1 <=
// 128. Returns the cudaError_t of the launch (0 on success).
extern "C" int mip_resample(const void* t, int ldt, const void* w, int ldw,
                            const void* u, int ldu, void* out, int n, int s,
                            float padding, void* stream) {
  if (n <= 0) return 0;
  if (s < 1 || s + 1 > kMax || ldt < 0 || ldw < 0 || ldu < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int rays = kThreads / G;
  mip_resample_kernel<<<(n + rays - 1) / rays, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), ldt, static_cast<const float*>(w), ldw,
      static_cast<const float*>(u), ldu, static_cast<float*>(out), n, s,
      padding);
  return (int)cudaGetLastError();
}
