// Weight grads of the fused MipMLP for a given output cotangent.
//
// Replaces the Pallas TPU kernels consistentnerf_tpu/ops/fused_mip.py::
// _bwd_pallas_T, the backward of the differentiable fused MipMLP that the
// one-pass mip train step runs on its MiDaS patch rays (through the VJP
// of fused_mip_mlp_train_T), and _bwd_pallas (fused_mip_bwd_row: the same
// walk on row-major [N, 3] streams and an [N, 4] cotangent, the VJP of
// fused_mip_mlp_train; mlp_common.cuh's RowMajor layout). Input: the
// samples' Gaussian means, diagonal covariances and view directions
// [3, N], the cotangent g of the raw heads [4, N] (rgb logits rows 0..2,
// density row 3), the packed weights.
// Output: dW and db in the packed layout, fp32, summed over the N points.
//
// Bound: operations, 3,556,608 FLOP a point at 8x256 / 16 IPE
// frequencies / view degree 4 (the forward, every dW, and the input
// gradient of every layer except into the IPE at layer 0 and the
// post-skip layer, and into the view encoding) against 68 bytes a point.
// Rounding: see mlp_train.cuh. The forward is run once more (the TPU
// kernel recomputed it too) with every activation saved.
//
// Design: fused_mlp_bwd.cu's, with the mip encoder (mlp_common.cuh::
// MipEnc). Both kernels at widths up to 256 run level_train.cuh's three
// launches in mode 2 (the level walk with g read into the chunk's
// cotangent rows, zero past its points; the split-K dW GEMM over a
// workspace row per point; a fixed-order reduction): a patch level of the
// mip step (98,304 points) is one wave of 128 chunks of 768. They replace
// train_block's mode-2 walk, whose dW pass re-read and re-stored every
// fp32 dW block per chunk (13.05 ms for #7 at a patch level on an H100 in
// bf16, 2.7% of the bound; 48.3 ms for #16 at 393,216 points, 2.9%; fp32
// #7 123.8-124.1 ms at 98,304 points and 234.9-235.1 ms at 196,608,
// tools/fp32_walk_ab.py). In fp32 (the mip presets' compute type) the
// walk's fp32 path, as #2's: the forward on the CUDA cores with the old
// walk's arithmetic, the backward's products and the dW GEMM as six bf16
// products a fp32 product on the weights' three planes w3 from the host
// and a three-plane workspace (29,952 B a point at 8x256 / 16
// frequencies: 2.94 GB at a patch level, 5.89 GB at the TV norm's
// 196,608 random-pose points). Its block keeps the forward's pe tile
// (26,624 B) in the weight ring beside the second activation tile
// (level_train.cuh::pe_in_ring): 209,920 B of dynamic shared memory at
// 768-row chunks, 212,224 with #16's row-major staging (pe in its own
// place: 236,544 and 238,848, past a block's 232,448 with the 1,328
// static bytes). The row-major kernel #16 differs only in its reads: each
// 64-point tile's means, covariances and views are staged into shared
// memory by one coalesced copy and encoded from there, and a point's 4
// cotangents are one 16-byte load; nothing after the walk knows the
// layout, so #16 gives #7's bits on the same points, in bf16 and in
// fp32. Widths over 256 keep train_block with its dW pass per 768-point
// chunk and a second launch that reduces the per-block partials in a
// fixed order, so every path gives the same bits from run to run.

#include "level_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

// WG: the level walk in mode 2 (streams in layout L; its dW in the GEMM
// that follows; in fp32 on three bf16 planes, ws then holding bf16). Else
// train_block's walk with its dW pass: widths over 256.
template <typename T, typename L, bool WG>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    fused_mip_bwd_kernel(const float* means, const float* covs,
                         const float* views, const float* g, int n,
                         const T* w, const float* b, T* ws, float* part,
                         size_t part_stride, int cpts, Dims d,
                         const __grid_constant__ mlp::WMapsN<mlp::kPlanes<T>>
                             maps) {
  mlp::RayRows rr{};
  rr.n_rays = n;
  rr.seg = 1;
  if constexpr (WG)
    mlp::level_walk<2, mlp::MipEnc, L, false, T>(
        means, covs, views, g, rr, w, b, reinterpret_cast<mlp::bf16*>(ws),
        part, part_stride, cpts, d, maps);
  else
    mlp::train_block<T, 2, mlp::MipEnc, L>(means, covs, views, g, rr, w, b,
                                           ws, part, part_stride, n, d);
}

// The nine slots of level_plan, in either type and layout (the legacy
// walk where the shapes are past the level walk's).
template <typename T, typename L>
int plan9(int n, const Dims& d, long long* pl) {
  return mlp::level_plan<L, false, T>(fused_mip_bwd_kernel<T, L, true>,
                                      fused_mip_bwd_kernel<T, L, false>, 2,
                                      n, 1, d, pl);
}

// wt: the weight planes the walk's maps read (w in bf16, w3 in fp32).
template <typename T, typename L>
int launch(const void* means, const void* covs, const void* views,
           const void* g, const void* w, const void* wt, const void* b,
           void* ws, void* part, void* gpart, void* dw, int n, Dims d,
           cudaStream_t stream) {
  long long pl[9];
  const int err = plan9<T, L>(n, d, pl);
  if (err) return err;
  return mlp::level_launch<T, false, mlp::kPlanes<T>>(
      fused_mip_bwd_kernel<T, L, true>, fused_mip_bwd_kernel<T, L, false>,
      pl, d, w, wt, b, ws, part, gpart, dw, stream,
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(views), static_cast<const float*>(g), n);
}

template <typename L>
int run(const void* means, const void* covs, const void* views,
        const void* g, const void* w, const void* w3, const void* b,
        void* ws, void* part, void* gpart, void* dw, int n, Dims d,
        int use_bf16, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return launch<bf16, L>(means, covs, views, g, w, w, b, ws, part, gpart,
                           dw, n, d, s);
  return launch<float, L>(means, covs, views, g, w, w3, b, ws, part, gpart,
                          dw, n, d, s);
}

}  // namespace

// out[0..8] as fused_mlp_bwd_plan's (nine slots). Returns a cudaError_t.
extern "C" int fused_mip_bwd_plan(int n, int depth, int width,
                                  int view_width, int skip_mask,
                                  int num_freqs, int deg_view, int use_bf16,
                                  long long* out) {
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  if (use_bf16) return plan9<bf16, mlp::ColMajor>(n, d, out);
  return plan9<float, mlp::ColMajor>(n, d, out);
}

// means, covs, views: [3, n] fp32; g: [4, n] fp32; w: packed weights
// (bf16 when use_bf16, else fp32); w3: in fp32 the weights' three bf16
// planes [3, w_total] (fused_mlp_v2.py::split3; unread in bf16); b:
// packed fp32 biases; ws, part, gpart: the plan's workspace (bf16 where
// the level walk runs, else of the weight type), block partials and split
// partials (fp32); dw: [w_total + b_total] fp32 out (dW then db, packed
// order).
extern "C" int fused_mip_bwd(const void* means, const void* covs,
                             const void* views, const void* g, const void* w,
                             const void* w3, const void* b, void* ws,
                             void* part, void* gpart, void* dw, int n,
                             int depth, int width, int view_width,
                             int skip_mask, int num_freqs, int deg_view,
                             int use_bf16, void* stream) {
  return run<mlp::ColMajor>(
      means, covs, views, g, w, w3, b, ws, part, gpart, dw, n,
      Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, stream);
}

// The row-major instance (#16): means, covs, views [n, 3] fp32; g [n, 4]
// fp32. Its plan fills the nine slots of fused_mip_bwd_plan (the
// row-major staging adds 9 x 64 floats to the walk's shared memory).
extern "C" int fused_mip_bwd_row_plan(int n, int depth, int width,
                                      int view_width, int skip_mask,
                                      int num_freqs, int deg_view,
                                      int use_bf16, long long* out) {
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  if (use_bf16) return plan9<bf16, mlp::RowMajor>(n, d, out);
  return plan9<float, mlp::RowMajor>(n, d, out);
}

// Arguments as fused_mip_bwd's, in the row-major layout.
extern "C" int fused_mip_bwd_row(const void* means, const void* covs,
                                 const void* views, const void* g,
                                 const void* w, const void* w3,
                                 const void* b, void* ws, void* part,
                                 void* gpart, void* dw, int n, int depth,
                                 int width, int view_width, int skip_mask,
                                 int num_freqs, int deg_view, int use_bf16,
                                 void* stream) {
  return run<mlp::RowMajor>(
      means, covs, views, g, w, w3, b, ws, part, gpart, dw, n,
      Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, stream);
}
