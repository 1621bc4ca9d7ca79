// The v1 fused NeRF-MLP forward on row-major streams, one entry point.
//
// Replaces two Pallas TPU kernels of the JAX package's first generation:
// consistentnerf_tpu/ops/fused_mlp.py::fused_mlp (the render's forward,
// [N, 3] points and view directions in, [N, 4] or [N, output_ch] out) and
// consistentnerf_tpu/ops/fused_mlp_train.py::_fwd_pallas (the forward of
// the differentiable op fused_mlp_train, [N, 4] out; its 128-lane output
// padding is a Mosaic relayout device and is not carried over). Both run
// _mlp_body per tile: the torch-Embedder PE computed in the kernel, bf16
// operands with fp32 accumulation, fp32 biases, trunk layers ReLU then
// bf16, `feature` bf16 without ReLU, alpha and rgb fp32; with float
// weights the same walk runs in fp32 on the CUDA cores.
//
// v1's math is exactly the one the port's walks compute, on the
// row-major stream layout (mlp_common.cuh::RowMajor) with the NeRF
// encoder. What v1 takes beyond the v2 kernels (Dims): heads on [pe | h]
// after a skip at the last trunk layer (the JAX NeRFMLP at netdepth 5),
// the use_viewdirs=False output head of `out_ch` channels, and PE degrees
// past the TPU v2 kernel's 20-frequency register (P = pad16(3 (1 + 2
// multires)); the shared-memory plan, fused_mlp_v1_fwd_smem_bytes, bounds
// P, and the wrapper refuses a config past 227 KB).
//
// Bound: operations (1,186,816 FLOP and 40 bytes a point at 8x256 /
// multires 10+4). Three walks, picked by shapes alone
// (fused_mlp_v1_fwd_plan): at #1's shapes (widths 64-256, heads on h with
// the view branch, P <= 128; the render #12 and the two-call levels #13
// at 8x256 / multires 10+4) the instances #10 runs under RowMajor
// (fwd_f32.cuh::fh_nerf_forward), in bf16 the Hopper walk of
// fwd_hopper.cuh and in fp32 the walk of fwd_f32.cuh, so #12 / #13 give
// #10's bits there; a skip into the heads, the output head and P > 128
// keep mlp_fwd.cuh's walk with v1's head shapes (activations of a tile of
// M points in shared memory, weights streamed from L2 into wmma fragments
// or, in fp32, read by the CUDA cores). No cross-block reduction: the
// output is deterministic.

#include "fwd_hopper.cuh"
#include "fwd_f32.cuh"

using mlp::bf16;
using mlp::Dims;

// The walk #12 / #13 take at these shapes: out[0..7] as mlp::fwd_plan_slots
// (slot 4 of mlp_fwd.cuh's walk: fused_mlp_v1_fwd_smem_bytes). Returns a
// cudaError_t.
extern "C" int fused_mlp_v1_fwd_plan(int n, int depth, int width,
                                     int skip_mask, int multires,
                                     int multires_views, int use_bf16,
                                     int out_ch, long long* out) {
  return mlp::fh_nerf_plan(Dims(depth, width, skip_mask, multires,
                                multires_views, 0, 0, out_ch),
                           n, use_bf16, out);
}

// Dynamic shared memory of one block of mlp_fwd.cuh's walk, in bytes.
extern "C" int fused_mlp_v1_fwd_smem_bytes(int width, int multires,
                                           int multires_views,
                                           int use_bf16) {
  const Dims d(1, width, 0, multires, multires_views);
  return (int)(use_bf16 ? mlp::fwd_smem_bytes<bf16, 128>(d)
                        : mlp::fwd_smem_bytes<float, 64>(d));
}

// pts, views: [n, 3] fp32 (views unread when out_ch > 0); w: packed
// weights (bf16 when use_bf16, else fp32; ops/fused_mlp_v2.py::pack with
// v1=True); b: packed fp32 biases; out: [n, 4] fp32 (rgb logits 0..2,
// density 3), or [n, out_ch] with the output head. skip_mask bit i: a
// skip concat after trunk layer i (bit depth - 1: the heads read
// [pe | h]). Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_mlp_v1_fwd(const void* pts, const void* views,
                                const void* w, const void* b, void* out,
                                int n, int depth, int width, int skip_mask,
                                int multires, int multires_views,
                                int use_bf16, int out_ch, void* stream) {
  if (n <= 0) return 0;
  return mlp::fh_nerf_forward<mlp::RowMajor, true>(
      pts, views, w, b, out, n,
      Dims(depth, width, skip_mask, multires, multires_views, 0, 0, out_ch),
      use_bf16, static_cast<cudaStream_t>(stream));
}
