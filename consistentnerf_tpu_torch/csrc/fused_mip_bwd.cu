// Weight grads of the fused MipMLP for a given output cotangent.
//
// Replaces the Pallas TPU kernels consistentnerf_tpu/ops/fused_mip.py::
// _bwd_pallas_T, the backward of the differentiable fused MipMLP that the
// one-pass mip train step runs on its MiDaS patch rays (through the VJP
// of fused_mip_mlp_train_T), and _bwd_pallas (fused_mip_bwd_row: the same
// walk on row-major [N, 3] streams and an [N, 4] cotangent, the VJP of
// fused_mip_mlp_train; mlp_common.cuh's RowMajor layout). Input: the samples' Gaussian means, diagonal
// covariances and view directions [3, N], the cotangent g of the raw
// heads [4, N] (rgb logits rows 0..2, density row 3), the packed weights.
// Output: dW and db in the packed layout, fp32, summed over the N points.
//
// Bound: operations, 3,556,608 FLOP a point at 8x256 / 16 IPE
// frequencies / view degree 4 (the forward, every dW, and the input
// gradient of every layer except into the IPE at layer 0 and the
// post-skip layer, and into the view encoding) against 68 bytes a point.
// Design and rounding: see mlp_train.cuh, whose mode-2 walk this kernel
// runs with the mip encoder (mlp_common.cuh::MipEnc). The forward is run
// once more (the TPU kernel recomputed it too) with every activation
// saved to the block's workspace, then the backward walk and the dW
// accumulation run per 768-point chunk; a second launch reduces the
// per-block partials in a fixed order, so the result is the same from
// run to run.

#include "mlp_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

template <typename T, typename L>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    fused_mip_bwd_kernel(const float* means, const float* covs,
                         const float* views, const float* g, const T* w,
                         const float* b, T* ws, float* part,
                         size_t part_stride, int n, Dims d) {
  mlp::RayRows rr{};
  rr.seg = 1;
  mlp::train_block<T, 2, mlp::MipEnc, L>(means, covs, views, g, rr, w, b,
                                         ws, part, part_stride, n, d);
}

template <typename T, typename L>
int launch(const void* means, const void* covs, const void* views,
           const void* g, const void* w, const void* b, void* ws, void* part,
           void* dw, int n, Dims d, cudaStream_t stream) {
  long long pl[4];
  int err = mlp::plan<T>(fused_mip_bwd_kernel<T, L>, 2, n, 1, d, pl);
  if (err) return err;
  fused_mip_bwd_kernel<T, L><<<(int)pl[0], mlp::kThreads, (size_t)pl[3],
                               stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(views), static_cast<const float*>(g),
      static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(ws), static_cast<float*>(part), (size_t)pl[2], n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = (int)(d.w_total() + d.b_total());
  mlp::mlp_train_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), (int)pl[0], (size_t)pl[2], total,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

template <typename L>
int plan_of(int n, Dims d, int use_bf16, long long* out) {
  if (use_bf16)
    return mlp::plan<bf16>(fused_mip_bwd_kernel<bf16, L>, 2, n, 1, d, out);
  return mlp::plan<float>(fused_mip_bwd_kernel<float, L>, 2, n, 1, d, out);
}

template <typename L>
int run(const void* means, const void* covs, const void* views,
        const void* g, const void* w, const void* b, void* ws, void* part,
        void* dw, int n, Dims d, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return launch<bf16, L>(means, covs, views, g, w, b, ws, part, dw, n, d,
                           s);
  return launch<float, L>(means, covs, views, g, w, b, ws, part, dw, n, d,
                          s);
}

}  // namespace

// out[0..3]: blocks, workspace elements per block, partial floats per
// block, dynamic shared memory bytes. Returns a cudaError_t.
extern "C" int fused_mip_bwd_plan(int n, int depth, int width,
                                  int view_width, int skip_mask,
                                  int num_freqs, int deg_view, int use_bf16,
                                  long long* out) {
  return plan_of<mlp::ColMajor>(
      n, Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, out);
}

// means, covs, views: [3, n] fp32; g: [4, n] fp32; w: packed weights
// (bf16 when use_bf16, else fp32); b: packed fp32 biases; ws: workspace
// (blocks x per-block elements of the weight type); part: blocks x stride
// fp32; dw: [w_total + b_total] fp32 out (dW then db, packed order).
extern "C" int fused_mip_bwd(const void* means, const void* covs,
                             const void* views, const void* g, const void* w,
                             const void* b, void* ws, void* part, void* dw,
                             int n, int depth, int width, int view_width,
                             int skip_mask, int num_freqs, int deg_view,
                             int use_bf16, void* stream) {
  return run<mlp::ColMajor>(
      means, covs, views, g, w, b, ws, part, dw, n,
      Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, stream);
}

// The row-major instance: means, covs, views [n, 3] fp32; g [n, 4] fp32;
// the rest (and its plan) as fused_mip_bwd.
extern "C" int fused_mip_bwd_row_plan(int n, int depth, int width,
                                      int view_width, int skip_mask,
                                      int num_freqs, int deg_view,
                                      int use_bf16, long long* out) {
  return plan_of<mlp::RowMajor>(
      n, Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, out);
}

extern "C" int fused_mip_bwd_row(const void* means, const void* covs,
                                 const void* views, const void* g,
                                 const void* w, const void* b, void* ws,
                                 void* part, void* dw, int n, int depth,
                                 int width, int view_width, int skip_mask,
                                 int num_freqs, int deg_view, int use_bf16,
                                 void* stream) {
  return run<mlp::RowMajor>(
      means, covs, views, g, w, b, ws, part, dw, n,
      Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, stream);
}
