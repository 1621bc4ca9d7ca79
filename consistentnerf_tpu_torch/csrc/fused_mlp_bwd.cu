// Weight grads of the fused NeRF MLP for a given output cotangent.
//
// Replaces the Pallas TPU kernels consistentnerf_tpu/ops/fused_mlp_v2.py::
// _bwd_pallas_T, the backward of the differentiable fused MLP that the
// one-pass train step runs on its patch rays, and _bwd_pallas
// (fused_mlp_bwd_row: the same walk on row-major [N, 3] points and views
// and an [N, 4] cotangent, mlp_common.cuh's RowMajor layout). Input: points and view
// directions [3, N], the cotangent g of the raw output [4, N] (rgb logits
// rows 0..2, density row 3), the packed weights. Output: dW and db in the
// packed layout, fp32, summed over the N points.
//
// Bound and rounding: see mlp_train.cuh. The forward is run once more
// (the TPU kernel recomputed it too) with every activation saved.
//
// Design. Both kernels at widths up to 256 run level_train.cuh's three
// launches in mode 2: the level walk (wgmma products fed by a TMA weight
// stream; g read into the chunk's cotangent rows, zero past its points),
// one split-K TMA/wgmma GEMM for every dW over a workspace row per point,
// and a fixed-order reduction. In fp32 the walk's fp32 path: the forward
// on the CUDA cores (the old walk's arithmetic), the backward's products
// and the dW GEMM as six bf16 products a fp32 product on the weights'
// three planes w3 from the host and a three-plane workspace. Chunks of up to 768 points, as
// many as keep the walk's last wave full (the one-pass step's fine patch
// launch, 196,608 points: 256 chunks of 768 in 2 waves). Against
// train_block's walk that replaced: its dW pass re-read and re-stored
// every fp32 dW block per 768-point chunk (2 x 2.4 MB), and its products
// loaded every weight fragment from L2 in each warp (25.0 ms at the fine
// patch launch on an H100, 2.8% of the bound). The row-major kernel #11
// differs only in its reads: each 64-point tile's points and views are
// staged into shared memory by one coalesced copy and encoded from
// there, and a point's 4 cotangents are one 16-byte load; nothing after
// the walk knows the layout, so #11 gives #2's bits on the same points,
// in bf16 and in fp32. fp32 #2 at the one-pass step's fine patch launch
// took 228.7 ms on mlp_train.cuh's SIMT walk on an H100 (its bound on the
// CUDA cores, 10.2 ms; with six bf16 products on the tensor cores, 4.2
// ms).
// Widths over 256 (and shapes past the walk's shared memory) keep
// train_block with its dW pass per chunk and a second launch that reduces
// the per-block partials in a fixed order.

#include "level_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

// WG: the level walk in mode 2 (streams in layout L; its dW in the GEMM
// that follows; in fp32 on three bf16 planes, ws then holding bf16). Else
// train_block's walk with its dW pass.
template <typename T, typename L, bool WG>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    fused_mlp_bwd_kernel(const float* pts, const float* views,
                         const float* g, int n, const T* w, const float* b,
                         T* ws, float* part, size_t part_stride, int cpts,
                         Dims d,
                         const __grid_constant__ mlp::WMapsN<mlp::kPlanes<T>>
                             maps) {
  mlp::RayRows rr{};
  rr.n_rays = n;
  rr.seg = 1;
  if constexpr (WG)
    mlp::level_walk<2, mlp::NerfEnc, L, false, T>(
        pts, nullptr, views, g, rr, w, b, reinterpret_cast<mlp::bf16*>(ws),
        part, part_stride, cpts, d, maps);
  else
    mlp::train_block<T, 2, mlp::NerfEnc, L>(pts, nullptr, views, g, rr, w,
                                            b, ws, part, part_stride, n, d);
}

// The nine slots of level_plan, in either type and layout (the legacy
// walk where the shapes are past the level walk's).
template <typename T, typename L>
int plan9(int n, const Dims& d, long long* pl) {
  return mlp::level_plan<L, false, T>(fused_mlp_bwd_kernel<T, L, true>,
                                      fused_mlp_bwd_kernel<T, L, false>, 2,
                                      n, 1, d, pl);
}

// wt: the weight planes the walk's maps read (w in bf16, w3 in fp32).
template <typename T, typename L>
int launch(const void* pts, const void* views, const void* g, const void* w,
           const void* wt, const void* b, void* ws, void* part, void* gpart,
           void* dw, int n, Dims d, cudaStream_t stream) {
  long long pl[9];
  const int err = plan9<T, L>(n, d, pl);
  if (err) return err;
  return mlp::level_launch<T, false, mlp::kPlanes<T>>(
      fused_mlp_bwd_kernel<T, L, true>, fused_mlp_bwd_kernel<T, L, false>,
      pl, d, w, wt, b, ws, part, gpart, dw, stream,
      static_cast<const float*>(pts), static_cast<const float*>(views),
      static_cast<const float*>(g), n);
}

template <typename L>
int run(const void* pts, const void* views, const void* g, const void* w,
        const void* w3, const void* b, void* ws, void* part, void* gpart,
        void* dw, int n, Dims d, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return launch<bf16, L>(pts, views, g, w, w, b, ws, part, gpart, dw, n,
                           d, s);
  return launch<float, L>(pts, views, g, w, w3, b, ws, part, gpart, dw, n,
                          d, s);
}

}  // namespace

// out[0..8] as onepass_level_plan's (onepass_level.cu): blocks, workspace
// elements, partial floats per block, dynamic shared memory bytes, points
// per chunk, dW GEMM splits, split partial floats, slabs per split, 1
// where the level walk runs (the last four 0 for train_block). Returns a
// cudaError_t.
extern "C" int fused_mlp_bwd_plan(int n, int depth, int width, int skip_mask,
                                  int multires, int multires_views,
                                  int use_bf16, long long* out) {
  const Dims d(depth, width, skip_mask, multires, multires_views);
  if (use_bf16) return plan9<bf16, mlp::ColMajor>(n, d, out);
  return plan9<float, mlp::ColMajor>(n, d, out);
}

// pts, views: [3, n] fp32; g: [4, n] fp32; w: packed weights (bf16 when
// use_bf16, else fp32); w3: in fp32 the weights' three bf16 planes [3,
// w_total] (fused_mlp_v2.py::split3; unread in bf16); b: packed fp32
// biases; ws, part, gpart: the plan's workspace (bf16 where the level walk
// runs, else of the weight type), block partials and split partials
// (fp32); dw: [w_total + b_total] fp32 out (dW then db, packed order).
extern "C" int fused_mlp_bwd(const void* pts, const void* views,
                             const void* g, const void* w, const void* w3,
                             const void* b, void* ws, void* part, void* gpart,
                             void* dw, int n, int depth, int width,
                             int skip_mask, int multires, int multires_views,
                             int use_bf16, void* stream) {
  return run<mlp::ColMajor>(
      pts, views, g, w, w3, b, ws, part, gpart, dw, n,
      Dims(depth, width, skip_mask, multires, multires_views), use_bf16,
      stream);
}

// The row-major instance (#11): pts, views [n, 3] fp32; g [n, 4] fp32.
// Its plan fills the nine slots of fused_mlp_bwd_plan (the row-major
// staging adds 9 x 64 floats to the walk's shared memory).
extern "C" int fused_mlp_bwd_row_plan(int n, int depth, int width,
                                      int skip_mask, int multires,
                                      int multires_views, int use_bf16,
                                      long long* out) {
  const Dims d(depth, width, skip_mask, multires, multires_views);
  if (use_bf16) return plan9<bf16, mlp::RowMajor>(n, d, out);
  return plan9<float, mlp::RowMajor>(n, d, out);
}

// Arguments as fused_mlp_bwd's, in the row-major layout.
extern "C" int fused_mlp_bwd_row(const void* pts, const void* views,
                                 const void* g, const void* w, const void* w3,
                                 const void* b, void* ws, void* part,
                                 void* gpart, void* dw, int n, int depth,
                                 int width, int skip_mask, int multires,
                                 int multires_views, int use_bf16,
                                 void* stream) {
  return run<mlp::RowMajor>(
      pts, views, g, w, w3, b, ws, part, gpart, dw, n,
      Dims(depth, width, skip_mask, multires, multires_views), use_bf16,
      stream);
}
