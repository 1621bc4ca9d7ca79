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
// multires 10+4) and weight layout: see mlp_fwd.cuh. Three walks, each
// under both stream layouts (#1 ColMajor, #10 RowMajor: the encoders read
// [n, 3] rows, the heads store [n, 4] rows), so #10 gives #1's bits on the
// same points: in bf16 at widths 64-256 the Hopper walk of fwd_hopper.cuh
// (persistent warp-specialised blocks, TMA weight ring, wgmma); in fp32 at
// widths 64-256 the walk of fwd_f32.cuh (persistent blocks, a bulk-copy
// weight ring, register-blocked fmas on the CUDA cores, fwd_tile's bits);
// other widths mlp_fwd.cuh::fwd_tile, all with the NeRF encoder
// (mlp_common.cuh::NerfEnc). The plan (fused_mlp_fwd_plan) decides by
// shapes alone, the same for both layouts. Both entries, and the v1
// forward (fused_mlp_v1_fwd.cu), run fwd_f32.cuh::fh_nerf_forward.

#include "fwd_hopper.cuh"
#include "fwd_f32.cuh"

using mlp::bf16;
using mlp::Dims;

// The walk #1 takes at these shapes (row: the row-major instance #10,
// whose plan is #1's): out[0..7] as mlp::fwd_plan_slots. Returns a
// cudaError_t.
extern "C" int fused_mlp_fwd_plan(int n, int depth, int width, int skip_mask,
                                  int multires, int multires_views,
                                  int use_bf16, int row, long long* out) {
  (void)row;
  return mlp::fh_nerf_plan(
      Dims(depth, width, skip_mask, multires, multires_views), n, use_bf16,
      out);
}

// Dynamic shared memory of one block of mlp_fwd.cuh::fwd_tile's walk, in
// bytes.
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

namespace {

// The two fp32 encoders on a tile of 64 points: mlp_common.cuh's (the
// encoders of fwd_tile; threads 0-255) into [0], fwd_hopper.cuh's FhEnc
// with fwd_f32.cuh's store (the fp32 walk's; threads 288-383) into [1],
// each [P + V, 64] feature-major (points, then views).
template <typename Enc>
__global__ void __launch_bounds__(mlp::kFfThreads)
    encode_check_kernel(const float* pts, const float* covs,
                        const float* views, float* out, int n, Dims d) {
  extern __shared__ __align__(16) float ec_tile[];
  constexpr int M = mlp::kFfTile, LD = mlp::kFfLd;
  float* a = ec_tile;                      // pe [64, P], then ve [64, V]
  float* f = a + (size_t)(d.P + d.V) * M;  // [P + V, LD] feature-major
  const int base = blockIdx.x * M, valid = min(M, n - base);
  for (int e = threadIdx.x; e < (d.P + d.V) * LD; e += blockDim.x) f[e] = 0.f;
  __syncthreads();
  if (threadIdx.x < mlp::kThreads) {  // point-major, as fwd_tile keeps them
    float* pe = a;
    float* ve = a + (size_t)M * d.P;
    Enc::template points<float, M>(pts, covs, n, base, valid, d, pe, d.P);
    Enc::template views<float, M>(views, n, base, valid, d, ve, d.V);
  } else if (threadIdx.x >= 288) {
    mlp::FhEnc<Enc>::template points<mlp::ColMajor, M>(
        pts, covs, n, base, valid, d, mlp::FfStore{f});
    mlp::FhEnc<Enc>::template views<mlp::ColMajor, M>(
        views, n, base, valid, d, mlp::FfStore{f + (size_t)d.P * LD});
  }
  __syncthreads();
  float* o0 = out + (size_t)blockIdx.x * (d.P + d.V) * M;
  float* o1 = o0 + (size_t)gridDim.x * (d.P + d.V) * M;
  for (int e = threadIdx.x; e < (d.P + d.V) * M; e += blockDim.x) {
    const int c = e / M, p = e % M;
    o0[e] = c < d.P ? a[p * d.P + c] : a[M * d.P + p * d.V + (c - d.P)];
    o1[e] = f[c * LD + p];
  }
}

}  // namespace

// The fp32 encodings of n points [3, n] (covs: the IPE's variances, read
// when ipe) by both encoders, fwd_tile's and the fp32 walk's, into out
// [2, tiles, P + V, 64] (tiles = ceil(n / 64); a tile's features, then
// points): the fp32 walk computes fwd_tile's function with its bits only
// if the two halves are equal bit for bit. Returns a cudaError_t.
extern "C" int fwd_f32_encode_check(const void* pts, const void* covs,
                                    const void* views, void* out, int n,
                                    int multires, int multires_views,
                                    int ipe, void* stream) {
  if (n <= 0) return 0;
  const Dims d(1, 64, 0, multires, multires_views, ipe, ipe ? 128 : 0);
  const int tiles = (n + mlp::kFfTile - 1) / mlp::kFfTile;
  const size_t smem = (size_t)(d.P + d.V) * (mlp::kFfTile + mlp::kFfLd) * 4;
  auto kernel = ipe ? encode_check_kernel<mlp::MipEnc>
                    : encode_check_kernel<mlp::NerfEnc>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiles, mlp::kFfThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(covs),
      static_cast<const float*>(views), static_cast<float*>(out), n, d);
  return (int)cudaGetLastError();
}
