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
// Bound, design and rounding of the MLP walks: see mlp_train.cuh.

#include "mlp_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

template <typename T>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    onepass_level_kernel(const float* pts, const float* views,
                         mlp::RayRows rr, const T* w, const float* b,
                         T* ws, float* part, size_t part_stride, Dims d) {
  mlp::train_block<T, 3, mlp::NerfEnc>(pts, nullptr, views, nullptr, rr, w,
                                       b, ws, part, part_stride,
                                       rr.n_rays * rr.seg, d);
}

template <typename T>
int launch(const void* pts, const void* views, mlp::RayRows rr,
           const void* w, const void* b, void* ws, void* part, void* dw,
           Dims d, cudaStream_t stream) {
  long long pl[4];
  int err = mlp::plan<T>(onepass_level_kernel<T>, 3, rr.n_rays * rr.seg,
                         rr.seg, d, pl);
  if (err) return err;
  onepass_level_kernel<T><<<(int)pl[0], mlp::kThreads, (size_t)pl[3],
                            stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(views), rr,
      static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(ws), static_cast<float*>(part), (size_t)pl[2], d);
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
extern "C" int onepass_level_plan(int n_rays, int seg, int depth, int width,
                                  int skip_mask, int multires,
                                  int multires_views, int use_bf16,
                                  long long* out) {
  Dims d(depth, width, skip_mask, multires, multires_views);
  if (use_bf16)
    return mlp::plan<bf16>(onepass_level_kernel<bf16>, 3, n_rays * seg,
                           seg, d, out);
  return mlp::plan<float>(onepass_level_kernel<float>, 3, n_rays * seg, seg,
                          d, out);
}

// pts, views: [3, n_rays*seg]; z: [n_rays*seg]; dn, crgb, cd, prior:
// [n_rays]; tgt: [3, n_rays]; out: [6, n_rays*seg]; all fp32. w, b, ws,
// part, dw as in fused_mlp_bwd.
extern "C" int onepass_level(const void* pts, const void* views,
                             const void* z, const void* dn, const void* crgb,
                             const void* tgt, const void* cd,
                             const void* prior, const void* w, const void* b,
                             void* out, void* ws, void* part, void* dw,
                             int n_rays, int seg, int depth, int width,
                             int skip_mask, int multires, int multires_views,
                             int white_bkgd, int use_bf16, void* stream) {
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
    return launch<bf16>(pts, views, rr, w, b, ws, part, dw, d, s);
  return launch<float>(pts, views, rr, w, b, ws, part, dw, d, s);
}
