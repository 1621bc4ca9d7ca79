// Fused NeRF-MLP forward: positional encoding + trunk + heads, one kernel.
//
// Replaces the Pallas TPU kernels consistentnerf_tpu/ops/fused_mlp_v2.py::
// _fwd_pallas_T (fused_mlp_fwd, transposed [3, N] streams) and
// _fwd_pallas (fused_mlp_fwd_row, row-major [N, 3] streams in, [N, 4] out;
// the TPU kernel's 128-lane output padding is not carried over): one walk
// under the two stream layouts of mlp_common.cuh. Same function as fused_mlp._mlp_body (torch Embedder
// order [x, sin(2^k x), cos(2^k x)]), same rounding points at bf16: PE in
// fp32 with accurate sinf/cosf then cast to bf16; every product takes bf16
// operands with fp32 accumulation; fp32 biases; trunk layers ReLU then
// bf16; `feature` cast to bf16 without ReLU; alpha and rgb stay fp32.
// With float weights the same kernel runs in fp32 on the CUDA cores.
//
// Bound (operations: 1,186,816 FLOP and 40 bytes a point at 8x256 /
// multires 10+4) and weight layout: see mlp_fwd.cuh. In bf16 at widths
// 64-256 both instances run the Hopper walk of fwd_hopper.cuh (persistent
// warp-specialised blocks, TMA weight ring, wgmma), #1 under the ColMajor
// layout and #10 under RowMajor (the encoders read [n, 3] rows, the heads
// store [n, 4] rows), so #10 gives #1's bits on the same points; fp32 and
// other widths run mlp_fwd.cuh's walk, both with the NeRF encoder
// (mlp_common.cuh::NerfEnc). The plan (fused_mlp_fwd_plan) decides by
// shapes alone, the same for both layouts. Both entries, and the v1
// forward (fused_mlp_v1_fwd.cu), run fwd_hopper.cuh::fh_nerf_forward.

#include "fwd_hopper.cuh"

using mlp::bf16;
using mlp::Dims;

// The walk #1 takes at these shapes (row: the row-major instance #10,
// whose plan is #1's): out[0..7] as mlp::fh_plan_slots. Returns a
// cudaError_t.
extern "C" int fused_mlp_fwd_plan(int n, int depth, int width, int skip_mask,
                                  int multires, int multires_views,
                                  int use_bf16, int row, long long* out) {
  (void)row;
  return mlp::fh_nerf_plan(
      Dims(depth, width, skip_mask, multires, multires_views), n, use_bf16,
      out);
}

// Dynamic shared memory of one block of mlp_fwd.cuh's walk, in bytes.
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
  return mlp::fh_nerf_forward<mlp::ColMajor>(
      pts, views, w, b, out, n,
      Dims(depth, width, skip_mask, multires, multires_views), use_bf16,
      static_cast<cudaStream_t>(stream));
}

// The row-major instance: pts, views [n, 3] fp32; out [n, 4] fp32 (rgb
// logits 0..2, density 3 per point); the rest as fused_mlp_fwd.
extern "C" int fused_mlp_fwd_row(const void* pts, const void* views,
                                 const void* w, const void* b, void* out,
                                 int n, int depth, int width, int skip_mask,
                                 int multires, int multires_views,
                                 int use_bf16, void* stream) {
  if (n <= 0) return 0;
  return mlp::fh_nerf_forward<mlp::RowMajor>(
      pts, views, w, b, out, n,
      Dims(depth, width, skip_mask, multires, multires_views), use_bf16,
      static_cast<cudaStream_t>(stream));
}
