// The v1 weight grads of the fused NeRF MLP for a given output cotangent.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/
// fused_mlp_train.py::_bwd_pallas: the backward of fused_mlp_train (the
// two-call step's "v1" op) and of hybrid_mlp_train ("hybrid", whose
// forward runs outside any kernel). Input: points and view directions
// [N, 3], the cotangent g of the raw output [N, 4] (rgb logits 0..2,
// density 3), the packed weights. Output: dW and db in the packed layout,
// fp32, summed over the N points; the op's input grads are zero and
// computed by nobody. The TPU kernel recomputed each tile's activations
// (_backward_tile) and carried dW in fp32 scratch across its sequential
// grid; here blocks run in parallel and every fp32 sum takes a fixed
// order (no atomics): bit-identical from run to run on a card. It differs
// from the TPU kernel's sequential fp32 sum only by rounding.
//
// Design. In bf16 at widths up to 256 (and an encoding whose tiles fit
// the walk's shared memory: every shape the JAX package's v1 path takes
// at width 256 up to multires 21) this is #11's kernel with v1's shapes:
// level_train.cuh's three launches in mode 2 under the row-major stream
// layout (the level walk, one split-K TMA/wgmma GEMM for every dW over a
// workspace row per point, a fixed-order reduction), its shape tables
// instantiated with V1 = true at a head skip (mlp_common.cuh::Dims: the
// feature and alpha heads on [pe | h] after a skip at the last trunk
// layer, so the feature layer's product and its dW read two segments,
// and the alpha head's dW takes its pe rows from the workspace). Where
// the heads read h alone (the main path's 8x256, skip after layer 4) v1's
// offsets are #11's, and so are the walk's instantiation and the bits
// (the V1 instantiation spills more registers; it took ~9% longer at the
// two-call fine level on an H100, chip_smoke.py). The fp32 path and what
// the walk cannot hold keep train_block<..., RowMajor, true>
// (mlp_train.cuh) with its dW pass per chunk and mlp_train_reduce;
// level_plan's shape test alone picks (slot 8 of the plan). Rounding as _backward_tile: bf16 operands of
// every product (the cotangent and each pre-activation gradient
// rounded), fp32 bias sums of the unrounded values, ReLU masks from the
// saved activations. Bound: operations (3x the forward's FLOP a point).

#include "level_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

// WG: the level walk in mode 2 (bf16; its dW in the GEMM that follows),
// with v1's heads on [pe | h] where HS (Dims::head_skip). Else
// train_block's walk with its dW pass (v1's heads whatever the shape;
// built with HS = false only).
template <typename T, bool WG, bool HS>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    fused_mlp_v1_bwd_kernel(const float* pts, const float* views,
                            const float* g, int n, const T* w,
                            const float* b, T* ws, float* part,
                            size_t part_stride, int cpts, Dims d,
                            const __grid_constant__ mlp::WMaps maps) {
  mlp::RayRows rr{};
  rr.n_rays = n;
  rr.seg = 1;
  if constexpr (WG)
    mlp::level_walk<2, mlp::NerfEnc, mlp::RowMajor, HS>(
        pts, nullptr, views, g, rr, w, b, ws, part, part_stride, cpts, d,
        maps);
  else
    mlp::train_block<T, 2, mlp::NerfEnc, mlp::RowMajor, true>(
        pts, nullptr, views, g, rr, w, b, ws, part, part_stride, n, d);
}

template <typename T>
constexpr bool kWalk = std::is_same<T, bf16>::value;

// The nine slots of level_plan (legacy_level_plan in fp32). Without a
// head skip the V1 sizes are the plain ones.
template <typename T, bool HS>
int plan9(int n, const Dims& d, long long* pl) {
  if constexpr (kWalk<T>)
    return mlp::level_plan<mlp::RowMajor, HS>(
        fused_mlp_v1_bwd_kernel<T, true, HS>,
        fused_mlp_v1_bwd_kernel<T, false, false>, 2, n, 1, d, pl);
  else
    return mlp::legacy_level_plan<T, true>(
        fused_mlp_v1_bwd_kernel<T, false, false>, 2, n, 1, d, pl);
}

template <typename T, bool HS>
int launch(const void* pts, const void* views, const void* g, const void* w,
           const void* b, void* ws, void* part, void* gpart, void* dw, int n,
           Dims d, cudaStream_t stream) {
  long long pl[9];
  const int err = plan9<T, HS>(n, d, pl);
  if (err) return err;
  return mlp::level_launch<T, HS>(
      fused_mlp_v1_bwd_kernel<T, kWalk<T>, kWalk<T> && HS>,
      fused_mlp_v1_bwd_kernel<T, false, false>, pl, d, w, w, b, ws, part,
      gpart, dw, stream, static_cast<const float*>(pts),
      static_cast<const float*>(views), static_cast<const float*>(g), n);
}

template <typename T>
int plan_any(int n, const Dims& d, long long* pl) {
  return d.head_skip() ? plan9<T, true>(n, d, pl) : plan9<T, false>(n, d, pl);
}

}  // namespace

// out[0..8] as fused_mlp_bwd_plan's (fused_mlp_bwd.cu): blocks, workspace
// elements (the whole launch), partial floats per block, dynamic shared
// memory bytes, points per chunk, dW GEMM splits, split partial floats,
// slabs per split, 1 where the level walk runs (the last four 0 for
// train_block). Returns a cudaError_t.
extern "C" int fused_mlp_v1_bwd_plan(int n, int depth, int width,
                                     int skip_mask, int multires,
                                     int multires_views, int use_bf16,
                                     long long* out) {
  const Dims d(depth, width, skip_mask, multires, multires_views);
  if (use_bf16) return plan_any<bf16>(n, d, out);
  return plan_any<float>(n, d, out);
}

// pts, views: [n, 3] fp32; g: [n, 4] fp32; w: packed weights (bf16 when
// use_bf16, else fp32; fused_mlp.py::pack_v1); b: packed fp32 biases; ws,
// part, gpart: the plan's workspace (of the weight type), block partials
// and split partials (fp32); dw: [w_total + b_total] fp32 out (dW then
// db, packed order).
extern "C" int fused_mlp_v1_bwd(const void* pts, const void* views,
                                const void* g, const void* w, const void* b,
                                void* ws, void* part, void* gpart, void* dw,
                                int n, int depth, int width, int skip_mask,
                                int multires, int multires_views,
                                int use_bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d(depth, width, skip_mask, multires, multires_views);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, HS) \
  launch<T, HS>(pts, views, g, w, b, ws, part, gpart, dw, n, d, s)
  if (use_bf16)
    return d.head_skip() ? LAUNCH(bf16, true) : LAUNCH(bf16, false);
  return d.head_skip() ? LAUNCH(float, true) : LAUNCH(float, false);
#undef LAUNCH
}
