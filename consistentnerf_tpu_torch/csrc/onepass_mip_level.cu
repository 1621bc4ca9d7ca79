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
// Bound on this card: operations, 3,556,608 FLOP a point at 8x256 / 16
// / 4 (see fused_mip_bwd.cu): 1.061 ms a level (294,912 points) at 989
// bf16 TFLOP/s.
//
// Design: level_train.cuh's walk in mode 4 with the mip encoder, the
// same three launches as onepass_level.cu (wgmma products fed by a TMA
// weight stream, the dW as one split-K GEMM over the level, a
// fixed-order reduction), and what they do about the old kernel's costs
// (half of its 38.7 ms a level in the bf16 dW pass, a third in the
// backward walk). A chunk is 8 rays of 96 samples (768 points; 3 waves
// at the flagship mip level, 1 at regnerf3's 1024 data rays). fp32 (the
// mip presets' compute type) runs the same launches on the walk's fp32
// path, as #3 does: the forward on the CUDA cores with the old walk's
// arithmetic (encode_ipe<float>, layer_f32), the backward's products and
// the dW GEMM as six bf16 products a fp32 product on the weights' three
// planes w3 and a three-plane workspace (29,952 B a point at 8x256, 2.94
// GB at 98,304 points). Its shared memory: the ring (98,304 B + 1,024
// alignment) holds the forward's second activation tile (67,584 B) and
// the pe tile (26,624 B) beside it (level_train.cuh::pe_in_ring); ve (10
// KB), one fp32 activation tile (67.6 KB), the chunk's rows and the
// column sums follow: 209,920 B a block, 211,248 with the static bytes
// (pe in its own place: 237,872, past a block's 232,448). The
// 32-point SIMT walk (mlp_train.cuh::train_block) it replaces took
// 127.5-127.8 ms a level at 1024 x 96 on an H100 (tools/fp32_walk_ab.py);
// widths over 256 keep it.

#include "level_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

// WG: the level walk of level_train.cuh (its dW in the GEMM that follows;
// in fp32 on three bf16 planes, ws then holding bf16). Else train_block's
// walk with its dW pass: widths over 256.
template <typename T, bool WG>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    onepass_mip_level_kernel(const float* means, const float* covs,
                             const float* views, mlp::RayRows rr,
                             const T* w, const float* b, T* ws, float* part,
                             size_t part_stride, int cpts, Dims d,
                             const __grid_constant__
                                 mlp::WMapsN<mlp::kPlanes<T>> maps) {
  if constexpr (WG)
    mlp::level_walk<4, mlp::MipEnc, mlp::ColMajor, false, T>(
        means, covs, views, nullptr, rr, w, b,
        reinterpret_cast<mlp::bf16*>(ws), part, part_stride, cpts, d, maps);
  else
    mlp::train_block<T, 4, mlp::MipEnc>(means, covs, views, nullptr, rr, w,
                                        b, ws, part, part_stride,
                                        rr.n_rays * rr.seg, d);
}

template <typename T>
int plan(int n_rays, int seg, const Dims& d, long long* pl) {
  return mlp::level_plan<mlp::ColMajor, false, T>(
      onepass_mip_level_kernel<T, true>, onepass_mip_level_kernel<T, false>,
      4, n_rays, seg, d, pl);
}

// wt: the weight planes the walk's maps read (w in bf16, w3 in fp32).
template <typename T>
int launch(const void* means, const void* covs, const void* views,
           mlp::RayRows rr, const void* w, const void* wt, const void* b,
           void* ws, void* part, void* gpart, void* dw, Dims d,
           cudaStream_t stream) {
  long long pl[9];
  const int err = plan<T>(rr.n_rays, rr.seg, d, pl);
  if (err) return err;
  return mlp::level_launch<T, false, mlp::kPlanes<T>>(
      onepass_mip_level_kernel<T, true>, onepass_mip_level_kernel<T, false>,
      pl, d, w, wt, b, ws, part, gpart, dw, stream,
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(views), rr);
}

}  // namespace

// out[0..8] as onepass_level_plan's. Returns a cudaError_t.
extern "C" int onepass_mip_level_plan(int n_rays, int seg, int depth,
                                      int width, int view_width,
                                      int skip_mask, int num_freqs,
                                      int deg_view, int use_bf16,
                                      long long* out) {
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  if (use_bf16) return plan<bf16>(n_rays, seg, d, out);
  return plan<float>(n_rays, seg, d, out);
}

// means, covs, views: [3, n_rays*seg]; tmid, delta, noise (null: none):
// [n_rays*seg]; tlo, thi, crgb, cd, prior: [n_rays]; tgt: [3, n_rays];
// out: [6, n_rays*seg]; all fp32. w, w3, b, ws, part, gpart, dw as in
// onepass_level (w3: in fp32 the weights' three bf16 planes, unread in
// bf16). rgb_scale = 1 + 2 rgb_padding (rounded to fp32 by the caller
// from its double, as the JAX kernel's Python constant is).
extern "C" int onepass_mip_level(
    const void* means, const void* covs, const void* views, const void* tmid,
    const void* delta, const void* noise, const void* tlo, const void* thi,
    const void* crgb, const void* tgt, const void* cd, const void* prior,
    const void* w, const void* w3, const void* b, void* out, void* ws,
    void* part,
    void* gpart, void* dw, int n_rays, int seg, int depth, int width,
    int view_width, int skip_mask, int num_freqs, int deg_view,
    int white_bkgd, int use_bf16, float rgb_scale, float rgb_padding,
    float density_bias, void* stream) {
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
    return launch<bf16>(means, covs, views, rr, w, w, b, ws, part, gpart, dw,
                        d, s);
  return launch<float>(means, covs, views, rr, w, w3, b, ws, part, gpart,
                       dw, d, s);
}
