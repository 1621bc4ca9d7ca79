// The mip-NeRF level resampler: blurpool of the level's weights, the
// padding, and the hardened inverse CDF over the fenceposts, one kernel.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/pdf_merge.py::
// mip_resample_t_vals. Input per ray: fenceposts t [S + 1] ascending,
// weights w [S], ascending draws u [S + 1] in [0, 1), fp32, S + 1 <= 128;
// the padding is a scalar argument. Output: the new fenceposts [S + 1].
// The function is core/sampling.py::resample_along_rays without the cone
// casting (RegNeRF mip.py:349-403, math.py:169-234):
//   blur_i = 0.5 (max(w_{i-1}, w_i) + max(w_i, w_{i+1})), edges duplicated;
//   w' = blur + padding, then + max(0, eps - sum w') on every weight;
//   pdf = w' / sum w'; cdf = [0, min(1, cumsum(pdf[:-1])), 1];
//   per draw the interval cdf_k <= u < cdf_{k+1},
//   t = clip((u - cdf_k) / (cdf_{k+1} - cdf_k), 0, 1) (0 where 0 / 0),
//   t' = t_k + t (t_{k+1} - t_k).
//
// Bound: bytes, 1,548 bytes a ray at S = 96 (t 388, w 384, u 388 in, t'
// 388 out) for ~1k operations, so an 8192-ray chunk needs at least 3.8 us
// at 3.35 TB/s. Design: one warp per ray with its rows in shared memory;
// lanes blur the weights, lane 0 sums and accumulates the cdf in index
// order, each lane finds its draws' intervals by binary search. Rounds as
// the plain PyTorch version (no fused multiply-add); deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMax = 128;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

__global__ void __launch_bounds__(kWarps * 32)
    mip_resample_kernel(const float* __restrict__ t,
                        const float* __restrict__ w,
                        const float* __restrict__ u, float* __restrict__ out,
                        int n, int s, float padding) {
  __shared__ float s_t[kWarps][kMax], s_w[kWarps][kMax],
      s_b[kWarps][kMax], s_cdf[kWarps][kMax];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n) return;  // whole warps leave; only warp barriers follow
  float* tv = s_t[warp];
  float* wv = s_w[warp];
  float* blur = s_b[warp];
  float* cdf = s_cdf[warp];

  const float* tr = t + (size_t)ray * (s + 1);
  const float* wr = w + (size_t)ray * s;
  for (int i = lane; i <= s; i += 32) tv[i] = tr[i];
  for (int i = lane; i < s; i += 32) wv[i] = wr[i];
  __syncwarp();
  for (int i = lane; i < s; i += 32) {
    const float wl = wv[i > 0 ? i - 1 : 0], wc = wv[i];
    const float wn = wv[i < s - 1 ? i + 1 : s - 1];
    blur[i] = __fadd_rn(
        __fmul_rn(0.5f, __fadd_rn(fmaxf(wl, wc), fmaxf(wc, wn))), padding);
  }
  __syncwarp();
  if (lane == 0) {
    float sum = 0.f;
    for (int i = 0; i < s; ++i) sum = __fadd_rn(sum, blur[i]);
    const float pad = fmaxf(__fsub_rn(kEps, sum), 0.f);
    float sum2 = 0.f;
    for (int i = 0; i < s; ++i) {
      blur[i] = __fadd_rn(blur[i], pad);
      sum2 = __fadd_rn(sum2, blur[i]);
    }
    float c = 0.f;
    cdf[0] = 0.f;
    for (int i = 0; i < s - 1; ++i) {
      c = __fadd_rn(c, __fdiv_rn(blur[i], sum2));
      cdf[i + 1] = fminf(c, 1.f);
    }
    cdf[s] = 1.f;
  }
  __syncwarp();

  const float* ur = u + (size_t)ray * (s + 1);
  float* orow = out + (size_t)ray * (s + 1);
  for (int j = lane; j <= s; j += 32) {
    const float uj = ur[j];
    int lo = 0, hi = s + 1;  // #{cdf <= u}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uj) lo = mid + 1;
      else hi = mid;
    }
    const int i0 = max(lo - 1, 0), i1 = min(lo, s);
    const float c0 = cdf[i0], c1 = cdf[i1];
    float f = __fdiv_rn(__fsub_rn(uj, c0), __fsub_rn(c1, c0));
    if (f != f) f = 0.f;  // 0 / 0
    f = fminf(fmaxf(f, 0.f), 1.f);
    orow[j] = __fadd_rn(tv[i0], __fmul_rn(f, __fsub_rn(tv[i1], tv[i0])));
  }
}

}  // namespace

// t: [n, s + 1]; w: [n, s]; u: [n, s + 1] ascending in [0, 1); out:
// [n, s + 1]; all fp32, contiguous; 1 <= s, s + 1 <= 128. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mip_resample(const void* t, const void* w, const void* u,
                            void* out, int n, int s, float padding,
                            void* stream) {
  if (n <= 0) return 0;
  if (s < 1 || s + 1 > kMax) return (int)cudaErrorInvalidValue;
  const int grid = (n + kWarps - 1) / kWarps;
  mip_resample_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(out), n, s, padding);
  return (int)cudaGetLastError();
}
