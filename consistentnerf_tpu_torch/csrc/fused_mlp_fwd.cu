// Fused NeRF-MLP forward: positional encoding + trunk + heads, one kernel.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/fused_mlp_v2.py::
// _fwd_pallas_T. Same function as fused_mlp._mlp_body (torch Embedder
// order [x, sin(2^k x), cos(2^k x)]), same rounding points at bf16: PE in
// fp32 with accurate sinf/cosf then cast to bf16; every product takes bf16
// operands with fp32 accumulation; fp32 biases; trunk layers ReLU then
// bf16; `feature` cast to bf16 without ReLU; alpha and rgb stay fp32.
// With float weights the same kernel runs in fp32 on the CUDA cores.
//
// Bound (operations: 1,186,816 FLOP and 40 bytes a point at 8x256 /
// multires 10+4), design and weight layout: see mlp_fwd.cuh, whose walk
// this kernel runs with the NeRF encoder (mlp_common.cuh::NerfEnc).

#include "mlp_fwd.cuh"

using mlp::bf16;
using mlp::Dims;

// Dynamic shared memory of one block, in bytes.
extern "C" int fused_mlp_fwd_smem_bytes(int width, int multires,
                                        int multires_views, int use_bf16) {
  const Dims d(1, width, 0, multires, multires_views);
  return (int)(use_bf16 ? mlp::fwd_smem_bytes<bf16, 128>(d)
                        : mlp::fwd_smem_bytes<float, 64>(d));
}

// pts, views: [3, n] fp32; w: packed weights (bf16 when use_bf16, else
// fp32); b: packed fp32 biases; out: [4, n] fp32 (rgb rows 0..2, alpha
// row 3). Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_mlp_fwd(const void* pts, const void* views,
                             const void* w, const void* b, void* out, int n,
                             int depth, int width, int skip_mask,
                             int multires, int multires_views, int use_bf16,
                             void* stream) {
  if (n <= 0) return 0;
  const Dims d(depth, width, skip_mask, multires, multires_views);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return mlp::fwd_launch<bf16, 128, mlp::NerfEnc>(pts, nullptr, views, w,
                                                    b, out, n, d, s);
  return mlp::fwd_launch<float, 64, mlp::NerfEnc>(pts, nullptr, views, w, b,
                                                  out, n, d, s);
}
