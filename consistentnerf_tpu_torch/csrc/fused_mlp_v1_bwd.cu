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
// grid; here blocks run in parallel, so each block sums its chunks' dW
// into its own fp32 partial and a second launch (mlp_train_reduce) adds
// the partials in block order: no atomics, bit-identical from run to run
// on a card. It differs from the TPU kernel's sequential fp32 sum only by
// rounding.
//
// The walk is mlp_train.cuh's mode 2 under the row-major stream layout
// (mlp_common.cuh::RowMajor) with the NeRF encoder, with v1's shapes: the
// heads on [pe | h] after a skip at the last trunk layer, and PE degrees
// past the TPU v2 kernel's 20-frequency register. Rounding as
// _backward_tile: bf16 operands of every product (the cotangent and each
// pre-activation gradient rounded), fp32 bias sums of the unrounded
// values, ReLU masks from the saved activations. Bound: operations
// (3x the forward's FLOP a point; see mlp_train.cuh for the design).

#include "mlp_train.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

template <typename T>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    fused_mlp_v1_bwd_kernel(const float* pts, const float* views,
                            const float* g, const T* w, const float* b,
                            T* ws, float* part, size_t part_stride, int n,
                            Dims d) {
  mlp::RayRows rr{};
  rr.seg = 1;
  mlp::train_block<T, 2, mlp::NerfEnc, mlp::RowMajor, true>(
      pts, nullptr, views, g, rr, w, b, ws, part, part_stride, n, d);
}

template <typename T>
int launch(const void* pts, const void* views, const void* g, const void* w,
           const void* b, void* ws, void* part, void* dw, int n, Dims d,
           cudaStream_t stream) {
  long long pl[4];
  int err = mlp::plan<T, true>(fused_mlp_v1_bwd_kernel<T>, 2, n, 1, d, pl);
  if (err) return err;
  fused_mlp_v1_bwd_kernel<T><<<(int)pl[0], mlp::kThreads, (size_t)pl[3],
                               stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(views),
      static_cast<const float*>(g), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(ws),
      static_cast<float*>(part), (size_t)pl[2], n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = (int)(d.w_total<true>() + d.b_total<true>());
  mlp::mlp_train_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), (int)pl[0], (size_t)pl[2], total,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

// out[0..3]: blocks, workspace elements per block, partial floats per
// block, dynamic shared memory bytes. Returns a cudaError_t.
extern "C" int fused_mlp_v1_bwd_plan(int n, int depth, int width,
                                     int skip_mask, int multires,
                                     int multires_views, int use_bf16,
                                     long long* out) {
  const Dims d(depth, width, skip_mask, multires, multires_views);
  if (use_bf16)
    return mlp::plan<bf16, true>(fused_mlp_v1_bwd_kernel<bf16>, 2, n, 1, d,
                                 out);
  return mlp::plan<float, true>(fused_mlp_v1_bwd_kernel<float>, 2, n, 1, d,
                                out);
}

// pts, views: [n, 3] fp32; g: [n, 4] fp32; w: packed weights (bf16 when
// use_bf16, else fp32); b: packed fp32 biases; ws: workspace (blocks x
// per-block elements of the weight type); part: blocks x stride fp32;
// dw: [w_total + b_total] fp32 out (dW then db, packed order).
extern "C" int fused_mlp_v1_bwd(const void* pts, const void* views,
                                const void* g, const void* w, const void* b,
                                void* ws, void* part, void* dw, int n,
                                int depth, int width, int skip_mask,
                                int multires, int multires_views,
                                int use_bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d(depth, width, skip_mask, multires, multires_views);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return launch<bf16>(pts, views, g, w, b, ws, part, dw, n, d, s);
  return launch<float>(pts, views, g, w, b, ws, part, dw, n, d, s);
}
