// The v1 fused NeRF-MLP forward on row-major streams, one kernel.
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
// The walk is mlp_fwd.cuh's under the row-major stream layout
// (mlp_common.cuh::RowMajor) with the NeRF encoder: v1's math is exactly
// the one the port's walks compute. What v1 takes beyond the v2 kernels
// (Dims): heads on [pe | h] after a skip at the last trunk layer (the JAX
// NeRFMLP at netdepth 5), the use_viewdirs=False output head of
// `out_ch` channels, and PE degrees past the TPU v2 kernel's 20-frequency
// register (P = pad16(3 (1 + 2 multires)); the shared-memory plan,
// fused_mlp_v1_fwd_smem_bytes, bounds P, and the wrapper refuses a config
// past 227 KB).
//
// Bound: operations (1,186,816 FLOP and 40 bytes a point at 8x256 /
// multires 10+4; see mlp_fwd.cuh for the design: activations of a tile
// of M points in shared memory, weights streamed from L2 into wmma
// fragments). No cross-block reduction: the output is deterministic.

#include "mlp_fwd.cuh"

using mlp::bf16;
using mlp::Dims;

// Dynamic shared memory of one block, in bytes.
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
  const Dims d(depth, width, skip_mask, multires, multires_views, 0, 0,
               out_ch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return mlp::fwd_launch<bf16, 128, mlp::NerfEnc, mlp::RowMajor, true>(
        pts, nullptr, views, w, b, out, n, d, s);
  return mlp::fwd_launch<float, 64, mlp::NerfEnc, mlp::RowMajor, true>(
      pts, nullptr, views, w, b, out, n, d, s);
}
