// Fused MipMLP forward: integrated positional encoding + trunk + heads,
// one kernel; and its normals variant.
//
// Replaces the Pallas TPU kernels consistentnerf_tpu/ops/fused_mip.py::
// _fwd_pallas_T, both without and with `with_normals`, and _fwd_pallas
// (fused_mip_fwd_row: the same walk on row-major [N, 3] streams, [N, 4]
// out, mlp_common.cuh's RowMajor layout). Input: the
// samples' Gaussian means, diagonal covariances and view directions [3, N]
// fp32. Output: the raw heads [4, N] fp32 (rgb logits rows 0..2, density
// logit row 3); sigmoid, rgb padding, softplus, density bias and noise stay
// outside, as in the JAX package. Same function and rounding points as
// fused_mip.py::_mip_body. The normals variant (fused_mip_fwd_normals)
// returns [7, N]: the raw heads, then d(raw density)/d(means) in rows 4..6
// (fused_mip.py::_mip_density_dmeans), which the render turns into
// normals.
//
// Bound: operations, 1,220,608 FLOP a point at 8x256 / 16 IPE
// frequencies / view degree 4 (610,304 MACs: 96->256, six 256->256, the
// post-skip 352->256, density 256->1, bottleneck 256->256, view layer
// 283->128, rgb 128->3) against 52 bytes (9 floats in, 4 out). Weight
// layout: see mlp_fwd.cuh. In bf16 at widths 64-256 both instances run
// the Hopper walk of fwd_hopper.cuh, with a 2-slot weight ring at 16
// frequencies (a 3-slot ring does not fit beside two 96-column pe
// buffers), #6 under the ColMajor layout and #15 under RowMajor (the
// encoders read [n, 3] rows, the heads store [n, 4] rows), so #15 gives
// #6's bits on the same points; fp32 and other widths run mlp_fwd.cuh's
// walk, both with the mip encoder (mlp_common.cuh::MipEnc). The plan
// (fused_mip_fwd_plan) decides by shapes alone, the same for both
// layouts; both entries run mip_forward. The TPU kernel's packed
// 128-lane IPE register, its pi/2 phase-bias row and its sin(2^-14 v)
// 2^14 raw-viewdir columns are Mosaic lane-layout devices; here each
// feature is computed on its own and the raw view directions are read as
// they are.
//
// The normals variant adds the density's walk back through the trunk
// (507,904 MACs at 8x256: every trunk layer's input gradient, and the
// gradient into the encoding at layer 0 and at the post-skip layer), so
// ~2.24 MFLOP a point against 64 bytes. The JAX function reads the
// forward's activations only as `act > 0`. In bf16 at widths 192 and 256,
// a trunk of at most 8 layers and 11-16 IPE frequencies (96 columns) it
// runs #6's Hopper walk with the normals tail of fwd_hopper.cuh: each
// trunk layer's ReLU mask kept in registers (one bit a unit), the walk
// back on wgmma over the trunk's weight slabs streamed again after the
// forward's, and the IPE's Jacobian per point at the end; no workspace.
// Its rows 0-3 are #6's bits. Elsewhere (fp32, other shapes) it runs the
// train walk (mlp_train.cuh, mode 5): a persistent grid whose blocks run
// 768-point chunks, save each layer's activations to a per-block
// workspace in device memory and walk the gradient back over 64-point
// sub-tiles; the IPE's Jacobian is applied per point at the end. The plan
// (fused_mip_fwd_normals_plan) decides by shapes alone. Rounding as the
// JAX kernel in both: the gradient is rounded to the compute type before
// each product, the products accumulate in fp32, the encoding's gradient
// stays fp32.

#include "fwd_hopper.cuh"
#include "mlp_train.cuh"

using mlp::bf16;
using mlp::Dims;

namespace {

// The Hopper walk's instances (fwd_hopper.cuh; bf16 on either layout):
// (width / 64, ceil(view width / 64)) at the MipMLP's widths 64, 128, 192,
// 256 with its 128-wide view layer.
bool mip_instance(const Dims& d) {
  return d.width / 64 >= 1 && d.width / 64 <= 4 && (d.half + 63) / 64 == 2;
}

template <typename L>
int hopper_launch(const mlp::FhPlan& pl, const void* means, const void* covs,
                  const void* views, const void* w, const void* b, void* out,
                  int n, const Dims& d, cudaStream_t s) {
  using mlp::MipEnc;
  constexpr int H = mlp::kFhHeads;
  switch (d.width / 64) {
    case 1:
      return mlp::fh_launch<MipEnc, 1, 2, H, 0, L>(pl, means, covs, views, w,
                                                   b, out, n, d, s);
    case 2:
      return mlp::fh_launch<MipEnc, 2, 2, H, 0, L>(pl, means, covs, views, w,
                                                   b, out, n, d, s);
    case 3:
      return mlp::fh_launch<MipEnc, 3, 2, H, 0, L>(pl, means, covs, views, w,
                                                   b, out, n, d, s);
    default:
      return mlp::fh_launch<MipEnc, 4, 2, H, 0, L>(pl, means, covs, views, w,
                                                   b, out, n, d, s);
  }
}

// The MipMLP forward of #6 (ColMajor) and #15 (RowMajor): the Hopper walk
// where fh_plan takes it, else mlp_fwd.cuh's walk (in fp32 on the CUDA
// cores). Returns a cudaError_t.
template <typename L>
int mip_forward(const void* means, const void* covs, const void* views,
                const void* w, const void* b, void* out, int n, const Dims& d,
                bool bf16_, cudaStream_t s) {
  if (n <= 0) return 0;
  mlp::FhPlan pl;
  const int err = mlp::fh_plan(d, n, bf16_, mip_instance(d), &pl);
  if (err) return err;
  if (pl.ok)
    return hopper_launch<L>(pl, means, covs, views, w, b, out, n, d, s);
  if (bf16_)
    return mlp::fwd_launch<bf16, 128, mlp::MipEnc, L>(means, covs, views, w,
                                                      b, out, n, d, s);
  return mlp::fwd_launch<float, 64, mlp::MipEnc, L>(means, covs, views, w, b,
                                                    out, n, d, s);
}

}  // namespace

// The walk #6 takes at these shapes (row: the row-major instance #15,
// whose plan is #6's): out[0..7] as mlp::fh_plan_slots. Returns a
// cudaError_t.
extern "C" int fused_mip_fwd_plan(int n, int depth, int width,
                                  int view_width, int skip_mask,
                                  int num_freqs, int deg_view, int use_bf16,
                                  int row, long long* out) {
  (void)row;
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  mlp::FhPlan pl;
  const int err = mlp::fh_plan(d, n, use_bf16, mip_instance(d), &pl);
  if (err) return err;
  mlp::fh_plan_slots(pl, d, n, use_bf16, out);
  return 0;
}

// means, covs, views: [3, n] fp32; w: packed weights (bf16 when use_bf16,
// else fp32); b: packed fp32 biases; out: [4, n] fp32. view_width: the
// view layer's width (<= width, a multiple of 16). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_mip_fwd(const void* means, const void* covs,
                             const void* views, const void* w, const void* b,
                             void* out, int n, int depth, int width,
                             int view_width, int skip_mask, int num_freqs,
                             int deg_view, int use_bf16, void* stream) {
  return mip_forward<mlp::ColMajor>(
      means, covs, views, w, b, out, n,
      Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, static_cast<cudaStream_t>(stream));
}

// The row-major instance: means, covs, views [n, 3] fp32; out [n, 4]
// fp32; the rest as fused_mip_fwd.
extern "C" int fused_mip_fwd_row(const void* means, const void* covs,
                                 const void* views, const void* w,
                                 const void* b, void* out, int n, int depth,
                                 int width, int view_width, int skip_mask,
                                 int num_freqs, int deg_view, int use_bf16,
                                 void* stream) {
  return mip_forward<mlp::RowMajor>(
      means, covs, views, w, b, out, n,
      Dims(depth, width, skip_mask, num_freqs, deg_view, 1, view_width),
      use_bf16, static_cast<cudaStream_t>(stream));
}

namespace {

template <typename T>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    mip_normals_kernel(const float* means, const float* covs,
                       const float* views, float* out, const T* w,
                       const float* b, T* ws, int n, Dims d) {
  mlp::RayRows rr{};
  rr.out = out;
  mlp::train_block<T, 5, mlp::MipEnc>(means, covs, views, nullptr, rr, w, b,
                                      ws, nullptr, 0, n, d);
}

// The normals walk's encoding-gradient width: the products of the pe rows
// are m64n96 (the IPE's 96 columns at 11-16 frequencies).
constexpr int kNormalsNP = 96;

// The Hopper walk with the normals tail at these shapes: #6's plan, a trunk
// of at most kFhMaskDepth layers (the masks' registers), an IPE of 65-96
// columns, and a warpgroup's rows of the tile large enough for the
// encoding's fp32 gradient (64 x 96: widths 192 and 256).
int normals_hopper_plan(const Dims& d, int n, bool bf16_, mlp::FhPlan* pl) {
  const int err = mlp::fh_plan(d, n, bf16_, mip_instance(d), pl);
  if (err) return err;
  if (!(d.depth <= mlp::kFhMaskDepth && d.P > 64 && d.P <= kNormalsNP &&
        256 * kNormalsNP <= pl->na * 64 * 128))
    pl->ok = 0;
  return 0;
}

int normals_hopper_launch(const mlp::FhPlan& pl, const void* means,
                          const void* covs, const void* views, const void* w,
                          const void* b, void* out, int n, const Dims& d,
                          cudaStream_t s) {
  using mlp::MipEnc;
  constexpr int T = mlp::kFhNormals;
  if (d.width / 64 == 3)
    return mlp::fh_launch<MipEnc, 3, 2, T, kNormalsNP>(pl, means, covs, views,
                                                       w, b, out, n, d, s);
  return mlp::fh_launch<MipEnc, 4, 2, T, kNormalsNP>(pl, means, covs, views, w,
                                                     b, out, n, d, s);
}

// Mode 5's plan (blocks, workspace elements per block, partials, shared
// memory) into p.
int mode5_plan(const Dims& d, int n, bool bf16_, long long* p) {
  if (bf16_) return mlp::plan<bf16>(mip_normals_kernel<bf16>, 5, n, 0, d, p);
  return mlp::plan<float>(mip_normals_kernel<float>, 5, n, 0, d, p);
}

}  // namespace

// The walk 6n takes at these shapes: out[0..7] as mlp::fh_plan_slots
// (mode 5: 0, points a chunk, 0, 1, shared memory, blocks, 0, chunks),
// out[8] where the masks live (1: registers, the Hopper walk; 0: mode 5
// saves every activation), out[9] workspace elements of the compute type
// (0 on the Hopper walk). Returns a cudaError_t.
extern "C" int fused_mip_fwd_normals_plan(int n, int depth, int width,
                                          int view_width, int skip_mask,
                                          int num_freqs, int deg_view,
                                          int use_bf16, long long* out) {
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  mlp::FhPlan pl;
  int err = normals_hopper_plan(d, n, use_bf16, &pl);
  if (err) return err;
  if (pl.ok) {
    mlp::fh_plan_slots(pl, d, n, use_bf16, out);
    out[8] = 1;
    out[9] = 0;
    return 0;
  }
  long long p5[4];
  err = mode5_plan(d, n, use_bf16, p5);
  if (err) return err;
  const int chunk = mlp::chunk_points(5, 0);
  const long long slots[10] = {0, chunk, 0, 1, p5[3], p5[0], 0,
                               (n + chunk - 1) / chunk, 0, p5[0] * p5[1]};
  for (int i = 0; i < 10; ++i) out[i] = slots[i];
  return 0;
}

// The normals variant: means, covs, views [3, n] fp32; w, b as in
// fused_mip_fwd; ws: mode 5's workspace (the plan's out[9] elements of the
// compute type; unused, may be null, on the Hopper walk); out: [7, n]
// fp32. Returns the cudaError_t of the launch.
extern "C" int fused_mip_fwd_normals(const void* means, const void* covs,
                                     const void* views, const void* w,
                                     const void* b, void* ws, void* out,
                                     int n, int depth, int width,
                                     int view_width, int skip_mask,
                                     int num_freqs, int deg_view,
                                     int use_bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d(depth, width, skip_mask, num_freqs, deg_view, 1, view_width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp::FhPlan hp;
  int err = normals_hopper_plan(d, n, use_bf16, &hp);
  if (err) return err;
  if (hp.ok)
    return normals_hopper_launch(hp, means, covs, views, w, b, out, n, d, s);
  long long pl[4];
  err = mode5_plan(d, n, use_bf16, pl);
  if (err) return err;
  if (use_bf16) {
    mip_normals_kernel<bf16><<<(int)pl[0], mlp::kThreads, (size_t)pl[3], s>>>(
        static_cast<const float*>(means), static_cast<const float*>(covs),
        static_cast<const float*>(views), static_cast<float*>(out),
        static_cast<const bf16*>(w), static_cast<const float*>(b),
        static_cast<bf16*>(ws), n, d);
  } else {
    mip_normals_kernel<float><<<(int)pl[0], mlp::kThreads, (size_t)pl[3],
                                s>>>(
        static_cast<const float*>(means), static_cast<const float*>(covs),
        static_cast<const float*>(views), static_cast<float*>(out),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(ws), n, d);
  }
  return (int)cudaGetLastError();
}
