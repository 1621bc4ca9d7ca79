// One-pass train kernel of one sampling level: MLP forward, volumetric
// compositing, per-ray loss cotangent, compositing VJP and MLP backward.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/fused_onepass.py::
// onepass_level_T. Input: points and view directions [3, N*S] (S samples
// per ray, ray-major), per-point depths z [N*S], and per-ray rows: |d|,
// the rgb coefficient, the rgb target [3, N], the depth coefficient and
// the depth prior. Output: rows [6, N*S] (rgb map, depth, acc broadcast
// per point, then the compositing weight of each point) and dW / db in
// the packed layout, fp32.
//
// Compositing follows the TPU kernel, not raw2outputs: v = max(1 - alpha,
// 1e-10) (not 1 - alpha + 1e-10), the last sample's distance is 1e10,
// d alpha = d_w * T - suffix / v with the exclusive suffix sum of
// d_w * w, the (sigma > 0) ReLU mask, and the white-background d_acc
// term (fused_onepass.py:125-178). The TPU's segmented lane scans become
// one thread per ray walking its S samples forward (transmittance, kept
// in shared memory) and back (suffix sums); a chunk holds whole rays, so
// the walk never leaves the block. The loss cotangent is
// coeff_rgb * (rgb - target) and coeff_d * (depth - prior); the
// batch-global denominators are in the coefficients, computed outside.
//
// Bound on this card: operations, 3,489,024 FLOP a point at 8x256 /
// multires 10+4 (forward, every dW, the needed input grads): 2.774 ms at
// the flagship step's fine level (786,432 points) at 989 bf16 TFLOP/s.
//
// Design (level_train.cuh): three launches a level. The walk runs
// forward, compositing and backward per chunk of whole rays with every
// layer product on wgmma, its weights streamed by TMA through a 3-slab
// ring in shared memory, and saves activations and rounded gradients to
// a workspace row per point; the dW of every matrix is one split-K
// TMA/wgmma GEMM over the level's points with its accumulators in
// registers over ~30,000 points; a reduction sums the partials in a fixed
// order. What that does about the old kernel's costs (the fine level on
// an H100, 98.8 ms before):
//   * the dW pass (52 ms): no partial re-read per 768-point chunk, async
//     copies overlapping the MMAs, A read once per K tile, the heads' dW
//     fused into the backward's elementwise steps;
//   * the backward walk (28 ms) and the forward (14 ms): weights no
//     longer fetched from L2 by every warp and waited on, but streamed
//     ahead into shared memory and fed to wgmma; the backward's mask,
//     rounding and bias sums done on the accumulators in registers;
//   * the saves (6.4 ms): 16-byte stores of whole rows;
//   * the waves: chunks sized so that the last wave is full (the coarse
//     level 8 rays a chunk, 4 full waves, where 12 rays made 2.6).
// fp32 (the presets' default compute type) runs the same three launches
// on level_train.cuh's fp32 walk: the forward on the CUDA cores with the
// old walk's arithmetic (so the ReLU masks agree with the fp32 plain
// version's), the backward's products and the dW GEMM as six bf16
// products a fp32 product (the weights split into three bf16 planes by
// the host, w3; the tiles split in registers; a three-plane workspace).
// Bounds at the fine level: 3x the forward's FLOP a point, 41.0 ms on the
// CUDA cores (67 TFLOP/s), 16.6 ms as six bf16 products on the tensor
// cores (164.8 TFLOP/s); mlp_train.cuh's 32-point SIMT walk took 924.4 ms
// on an H100. A shape past the walk's shared memory, or widths over 256,
// keeps that walk (slot 8 of the plan = 0).

#include "level_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

// WG: the level walk of level_train.cuh (its dW in the GEMM that
// follows; in fp32 on three bf16 planes, ws then holding bf16). Else
// train_block's walk with its dW pass: the shapes past the walk's (widths
// over 256, a shared memory too small).
template <typename T, bool WG>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    onepass_level_kernel(const float* pts, const float* views,
                         mlp::RayRows rr, const T* w, const float* b,
                         T* ws, float* part, size_t part_stride, int cpts,
                         Dims d,
                         const __grid_constant__ mlp::WMapsN<mlp::kPlanes<T>>
                             maps) {
  if constexpr (WG)
    mlp::level_walk<3, mlp::NerfEnc, mlp::ColMajor, false, T>(
        pts, nullptr, views, nullptr, rr, w, b,
        reinterpret_cast<mlp::bf16*>(ws), part, part_stride, cpts, d, maps);
  else
    mlp::train_block<T, 3, mlp::NerfEnc>(pts, nullptr, views, nullptr, rr,
                                         w, b, ws, part, part_stride,
                                         rr.n_rays * rr.seg, d);
}

template <typename T>
int plan(int n_rays, int seg, const Dims& d, long long* pl) {
  return mlp::level_plan<mlp::ColMajor, false, T>(
      onepass_level_kernel<T, true>, onepass_level_kernel<T, false>, 3,
      n_rays, seg, d, pl);
}

// wt: the weight planes the walk's maps read (w in bf16, w3 in fp32).
template <typename T>
int launch(const void* pts, const void* views, mlp::RayRows rr,
           const void* w, const void* wt, const void* b, void* ws,
           void* part, void* gpart, void* dw, Dims d, cudaStream_t stream) {
  long long pl[9];
  const int err = plan<T>(rr.n_rays, rr.seg, d, pl);
  if (err) return err;
  return mlp::level_launch<T, false, mlp::kPlanes<T>>(
      onepass_level_kernel<T, true>, onepass_level_kernel<T, false>, pl, d,
      w, wt, b, ws, part, gpart, dw, stream, static_cast<const float*>(pts),
      static_cast<const float*>(views), rr);
}

}  // namespace

// out[0..8]: blocks, workspace elements, partial floats per block,
// dynamic shared memory bytes, points per chunk, dW GEMM splits, split
// partial floats, slabs per split, 1 where the walk runs on wgmma (the
// last four 0 where train_block runs). Returns a cudaError_t.
extern "C" int onepass_level_plan(int n_rays, int seg, int depth, int width,
                                  int skip_mask, int multires,
                                  int multires_views, int use_bf16,
                                  long long* out) {
  Dims d(depth, width, skip_mask, multires, multires_views);
  if (use_bf16) return plan<bf16>(n_rays, seg, d, out);
  return plan<float>(n_rays, seg, d, out);
}

// pts, views: [3, n_rays*seg]; z: [n_rays*seg]; dn, crgb, cd, prior:
// [n_rays]; tgt: [3, n_rays]; out: [6, n_rays*seg]; all fp32. w, b: the
// packed weights; w3: in fp32 the weights' three bf16 planes [3, w_total]
// (fused_mlp_v2.py::split3; unread in bf16); ws, part, gpart: the plan's
// workspace (bf16 where the walk runs), block partials and split
// partials; dw: the packed grad [w_total + b_total], fp32.
extern "C" int onepass_level(const void* pts, const void* views,
                             const void* z, const void* dn, const void* crgb,
                             const void* tgt, const void* cd,
                             const void* prior, const void* w,
                             const void* w3, const void* b,
                             void* out, void* ws, void* part, void* gpart,
                             void* dw, int n_rays, int seg, int depth,
                             int width, int skip_mask, int multires,
                             int multires_views, int white_bkgd,
                             int use_bf16, void* stream) {
  if (n_rays <= 0) return 0;
  Dims d(depth, width, skip_mask, multires, multires_views);
  mlp::RayRows rr{};
  rr.z = static_cast<const float*>(z);
  rr.dn = static_cast<const float*>(dn);
  rr.crgb = static_cast<const float*>(crgb);
  rr.tgt = static_cast<const float*>(tgt);
  rr.cd = static_cast<const float*>(cd);
  rr.prior = static_cast<const float*>(prior);
  rr.out = static_cast<float*>(out);
  rr.n_rays = n_rays;
  rr.seg = seg;
  rr.white = white_bkgd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return launch<bf16>(pts, views, rr, w, w, b, ws, part, gpart, dw, d, s);
  return launch<float>(pts, views, rr, w, w3, b, ws, part, gpart, dw, d, s);
}
