// One-pass train kernel of one mip sampling level: MipMLP forward, mip
// compositing, per-ray loss cotangent, compositing VJP and MLP backward.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/fused_onepass.py::
// onepass_mip_level_T. Input: the samples' Gaussian means, diagonal
// covariances and view directions [3, N*S] (S samples per ray,
// ray-major), per point the fencepost midpoint tmid, the interval length
// delta = (t1 - t0) |d| and an optional density-noise row (added to the
// density logit), and per ray the clip bounds tlo = t_0, thi = t_S, the
// rgb coefficient, the rgb target [3, N], the distance coefficient and
// prior. Output: rows [6, N*S] (rgb map, distance_mean and acc broadcast
// per point, then each point's compositing weight, which the next level
// resamples from) and dW / db in the packed layout, fp32.
//
// Compositing follows the TPU kernel's (_mip_composite_fwd/_bwd,
// fused_onepass.py:307-371), not vanilla's: c = sigmoid(raw) (1 + 2 pad)
// - pad; density = softplus(raw + bias + noise); trans = exp(-exclusive
// cumsum(density delta)); distance_mean = clip(sum w tmid / max(acc,
// 1e-37), t_0, t_S), t_S where acc == 0; the distance cotangent passes
// only strictly inside the clip range; d dd = d_w trans (1 - alpha) -
// reverse-exclusive-sum(d_w w). The TPU's segmented lane scans become one
// thread per ray walking its S samples forward (transmittance kept in
// shared memory) and back (suffix sums); a chunk holds whole rays (8 rays
// of 96 samples fill the 768-point chunk), so the walk never leaves the
// block. The loss cotangent is coeff_rgb (rgb - target) and coeff_d
// (distance - prior); the batch-global denominators are in the
// coefficients, computed outside.
//
// Bound: operations, 3,556,608 FLOP a point at 8x256 / 16 / 4 (see
// fused_mip_bwd.cu). Design and rounding of the MLP walks: see
// mlp_train.cuh, whose mode-4 walk this kernel runs with the mip encoder.

#include "mlp_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

template <typename T>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    onepass_mip_level_kernel(const float* means, const float* covs,
                             const float* views, mlp::RayRows rr,
                             const T* w, const float* b, T* ws, float* part,
                             size_t part_stride, Dims d) {
  mlp::train_block<T, 4, mlp::MipEnc>(means, covs, views, nullptr, rr, w, b,
                                      ws, part, part_stride,
                                      rr.n_rays * rr.seg, d);
}

template <typename T>
int launch(const void* means, const void* covs, const void* views,
           mlp::RayRows rr, const void* w, const void* b, void* ws,
           void* part, void* dw, Dims d, cudaStream_t stream) {
  long long pl[4];
  int err = mlp::plan<T>(onepass_mip_level_kernel<T>, 4, rr.n_rays * rr.seg,
                         rr.seg, d, pl);
  if (err) return err;
  onepass_mip_level_kernel<T><<<(int)pl[0], mlp::kThreads, (size_t)pl[3],
                                stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(views), rr, static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(ws),
      static_cast<float*>(part), (size_t)pl[2], d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = (int)(d.w_total() + d.b_total());
  mlp::mlp_train_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), (int)pl[0], (size_t)pl[2], total,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

// out[0..3]: blocks, workspace elements per block, partial floats per
// block, dynamic shared memory bytes. Returns a cudaError_t.
extern "C" int onepass_mip_level_plan(int n_rays, int seg, int depth,
                                      int width, int view_width,
                                      int skip_mask, int num_freqs,
                                      int deg_view, int use_bf16,
                                      long long* out) {
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  if (use_bf16)
    return mlp::plan<bf16>(onepass_mip_level_kernel<bf16>, 4, n_rays * seg,
                           seg, d, out);
  return mlp::plan<float>(onepass_mip_level_kernel<float>, 4, n_rays * seg,
                          seg, d, out);
}

// means, covs, views: [3, n_rays*seg]; tmid, delta, noise (null: none):
// [n_rays*seg]; tlo, thi, crgb, cd, prior: [n_rays]; tgt: [3, n_rays];
// out: [6, n_rays*seg]; all fp32. w, b, ws, part, dw as in fused_mip_bwd.
// rgb_scale = 1 + 2 rgb_padding (rounded to fp32 by the caller from its
// double, as the JAX kernel's Python constant is).
extern "C" int onepass_mip_level(
    const void* means, const void* covs, const void* views, const void* tmid,
    const void* delta, const void* noise, const void* tlo, const void* thi,
    const void* crgb, const void* tgt, const void* cd, const void* prior,
    const void* w, const void* b, void* out, void* ws, void* part, void* dw,
    int n_rays, int seg, int depth, int width, int view_width, int skip_mask,
    int num_freqs, int deg_view, int white_bkgd, int use_bf16,
    float rgb_scale, float rgb_padding, float density_bias, void* stream) {
  if (n_rays <= 0) return 0;
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  mlp::RayRows rr{};
  rr.tmid = static_cast<const float*>(tmid);
  rr.delta = static_cast<const float*>(delta);
  rr.noise = static_cast<const float*>(noise);
  rr.tlo = static_cast<const float*>(tlo);
  rr.thi = static_cast<const float*>(thi);
  rr.crgb = static_cast<const float*>(crgb);
  rr.tgt = static_cast<const float*>(tgt);
  rr.cd = static_cast<const float*>(cd);
  rr.prior = static_cast<const float*>(prior);
  rr.out = static_cast<float*>(out);
  rr.n_rays = n_rays;
  rr.seg = seg;
  rr.white = white_bkgd;
  rr.rgb_scale = rgb_scale;
  rr.rgb_padding = rgb_padding;
  rr.density_bias = density_bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return launch<bf16>(means, covs, views, rr, w, b, ws, part, dw, d, s);
  return launch<float>(means, covs, views, rr, w, b, ws, part, dw, d, s);
}
