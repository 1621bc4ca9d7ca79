// Fine-level resampling of the vanilla renderer: inverse-CDF sampling over
// the coarse weights and the merge of the samples with the coarse depths,
// one kernel.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/pdf_merge.py::
// sample_pdf_merged. Input per ray: the ascending coarse depths z_c [S_c],
// the interior compositing weights w [S_c - 2] and ascending draws u [S_i]
// in [0, 1], fp32, S_c and S_i <= 128. Output per ray: the samples z_s
// [S_i] and sort(concat(z_c, z_s)) [S_c + S_i]. The function is
// core/sampling.py::sample_pdf over the midpoints of z_c
// (run_nerf_helpers.py:206-250): pdf = (w + 1e-5) / sum, the exclusive
// cdf in index order, below / above = the interval with
// cdf_k <= u < cdf_{k+1} (the last interval closed on the right), the
// denominator 1 where it is below 1e-5, linear interpolation of the
// midpoints.
//
// Bound: bytes. A ray moves 2,296 bytes (z_c 256, w 248, u 512 in; merged
// 768, z_s 512 out at S_c = 64, S_i = 128) for ~1k operations, so an
// 8192-ray chunk needs at least 5.6 us at 3.35 TB/s. Design: one warp per
// ray, the ray's rows in shared memory. The TPU kernel's lane devices (a
// log-roll prefix sum, a 63-step masked interval loop, a 256-lane bitonic
// merge with +-1e38 pads) do not carry over: lane 0 sums the pdf and the
// cdf in index order, each lane takes draws and finds their interval by
// binary search, and since both inputs are ascending the merge is a
// merge-path rank: z_c[i] goes to i + #{z_s < z_c[i]}, z_s[j] to
// j + #{z_c <= z_s[j]}, no sort. The inverse CDF is monotone, but its
// fp32 rounding can put one sample an ulp above the next where two
// intervals meet; a warp vote finds such a pair and lane 0 then
// insertion-sorts the samples, so the ranks are always a permutation. The
// arithmetic rounds as the plain PyTorch version does (no fused
// multiply-add), and nothing crosses blocks: the output is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMax = 128;

// First index of the ascending a[0, n) with a[i] > x.
__device__ inline int upper_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First index of the ascending a[0, n) with a[i] >= x.
__device__ inline int lower_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32)
    pdf_merge_kernel(const float* __restrict__ zc, const float* __restrict__ w,
                     const float* __restrict__ u, float* __restrict__ merged,
                     float* __restrict__ zs_out, int n, int s_c, int s_i) {
  __shared__ float s_z[kWarps][kMax], s_mid[kWarps][kMax],
      s_w[kWarps][kMax], s_cdf[kWarps][kMax], s_zs[kWarps][kMax];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n) return;  // whole warps leave; only warp barriers follow
  float* z = s_z[warp];
  float* mid = s_mid[warp];
  float* wv = s_w[warp];
  float* cdf = s_cdf[warp];
  float* zs = s_zs[warp];
  const int m = s_c - 1;  // bins (midpoints) and cdf entries

  const float* zr = zc + (size_t)ray * s_c;
  const float* wr = w + (size_t)ray * (s_c - 2);
  for (int i = lane; i < s_c; i += 32) z[i] = zr[i];
  for (int i = lane; i < s_c - 2; i += 32) wv[i] = __fadd_rn(wr[i], 1e-5f);
  __syncwarp();
  for (int i = lane; i < m; i += 32)
    mid[i] = __fmul_rn(0.5f, __fadd_rn(z[i], z[i + 1]));
  if (lane == 0) {
    float sum = 0.f;
    for (int k = 0; k < m - 1; ++k) sum = __fadd_rn(sum, wv[k]);
    float c = 0.f;
    cdf[0] = 0.f;
    for (int k = 0; k < m - 1; ++k) {
      c = __fadd_rn(c, __fdiv_rn(wv[k], sum));
      cdf[k + 1] = c;
    }
  }
  __syncwarp();

  const float* ur = u + (size_t)ray * s_i;
  for (int j = lane; j < s_i; j += 32) {
    const float uj = ur[j];
    const int idx = upper_bound(cdf, m, uj);  // #{cdf <= u}
    const int below = max(idx - 1, 0), above = min(idx, m - 1);
    const float c0 = cdf[below], c1 = cdf[above];
    float denom = __fsub_rn(c1, c0);
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(uj, c0), denom);
    const float b0 = mid[below], b1 = mid[above];
    zs[j] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));
  }
  __syncwarp();
  bool inverted = false;
  for (int j = 1 + lane; j < s_i; j += 32) inverted |= zs[j] < zs[j - 1];
  if (__any_sync(0xffffffffu, inverted)) {
    if (lane == 0)
      for (int j = 1; j < s_i; ++j) {
        const float x = zs[j];
        int k = j - 1;
        for (; k >= 0 && zs[k] > x; --k) zs[k + 1] = zs[k];
        zs[k + 1] = x;
      }
    __syncwarp();
  }

  float* mo = merged + (size_t)ray * (s_c + s_i);
  for (int i = lane; i < s_c; i += 32)
    mo[i + lower_bound(zs, s_i, z[i])] = z[i];
  for (int j = lane; j < s_i; j += 32) {
    mo[j + upper_bound(z, s_c, zs[j])] = zs[j];
    zs_out[(size_t)ray * s_i + j] = zs[j];
  }
}

}  // namespace

// z_c: [n, s_c] ascending; w: [n, s_c - 2]; u: [n, s_i] ascending in
// [0, 1]; merged: [n, s_c + s_i]; z_s: [n, s_i]; all fp32, contiguous;
// 3 <= s_c <= 128, 1 <= s_i <= 128. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int pdf_merge(const void* z_c, const void* w, const void* u,
                         void* merged, void* z_s, int n, int s_c, int s_i,
                         void* stream) {
  if (n <= 0) return 0;
  if (s_c < 3 || s_c > kMax || s_i < 1 || s_i > kMax)
    return (int)cudaErrorInvalidValue;
  const int grid = (n + kWarps - 1) / kWarps;
  pdf_merge_kernel<<<grid, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z_c), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(merged),
      static_cast<float*>(z_s), n, s_c, s_i);
  return (int)cudaGetLastError();
}
