// Fused MipMLP forward: integrated positional encoding + trunk + heads,
// one kernel.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/fused_mip.py::
// _fwd_pallas_T (without its `with_normals` rows). Input: the samples'
// Gaussian means, diagonal covariances and view directions [3, N] fp32.
// Output: the raw heads [4, N] fp32 (rgb logits rows 0..2, density logit
// row 3); sigmoid, rgb padding, softplus, density bias and noise stay
// outside, as in the JAX package. Same function and rounding points as
// fused_mip.py::_mip_body.
//
// Bound: operations, 1,220,608 FLOP a point at 8x256 / 16 IPE
// frequencies / view degree 4 (610,304 MACs: 96->256, six 256->256, the
// post-skip 352->256, density 256->1, bottleneck 256->256, view layer
// 283->128, rgb 128->3) against 52 bytes (9 floats in, 4 out). Design and
// weight layout: see mlp_fwd.cuh, whose walk this kernel runs with the
// mip encoder (mlp_common.cuh::MipEnc). The TPU kernel's packed 128-lane
// IPE register, its pi/2 phase-bias row and its sin(2^-14 v) 2^14
// raw-viewdir columns are Mosaic lane-layout devices; here each feature
// is computed on its own and the raw view directions are read as they
// are.

#include "mlp_fwd.cuh"

using mlp::bf16;
using mlp::Dims;

// means, covs, views: [3, n] fp32; w: packed weights (bf16 when use_bf16,
// else fp32); b: packed fp32 biases; out: [4, n] fp32. view_width: the
// view layer's width (<= width, a multiple of 16). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_mip_fwd(const void* means, const void* covs,
                             const void* views, const void* w, const void* b,
                             void* out, int n, int depth, int width,
                             int view_width, int skip_mask, int num_freqs,
                             int deg_view, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    return mlp::fwd_launch<bf16, 128, mlp::MipEnc>(means, covs, views, w, b,
                                                   out, n, d, s);
  return mlp::fwd_launch<float, 64, mlp::MipEnc>(means, covs, views, w, b,
                                                 out, n, d, s);
}
