// Render level kernel: the NeRF-MLP forward and the volumetric compositing
// of whole rays in one launch, no gradients.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/fused_onepass.py::
// render_level_T. Input: points and view directions [3, N*S] (S samples
// per ray, ray-major), per-point depths z [N*S] and per-ray |d| [N], fp32.
// Output: rows [6, N*S] fp32: the rgb map (0..2), depth (3) and acc (4)
// broadcast over each ray's samples, and each sample's compositing weight
// (5), which the fine level's inverse CDF reads.
//
// Bound: operations, as the forward kernel (fused_mlp_fwd.cu): 1,186,816
// FLOP a point at 8x256 / multires 10+4 against 52 bytes (7 floats in, 6
// out; |d| once a ray), so the fine level's 8192-ray chunk (1,572,864
// points) needs at least 1.887 ms at 989 bf16 TFLOP/s, the coarse 0.629.
//
// In bf16 at the forward walk's widths (64-256) the kernel is #1's Hopper
// walk (fwd_hopper.cuh) with the compositing tail: persistent blocks walk
// groups of lcm(S, 128) points, whole rays (fine S = 192: 384 points, 3
// tiles, 2 rays; coarse S = 64: 128 points, 1 tile, 2 rays); the heads stay
// in the group's buffer in shared memory (6 KB at 384 points), and the
// producer's encoder warps composite each ray with one warp while the
// consumers run the next group's trunk. The heads are #1's bits on the
// same points. The plan (render_level_plan) decides by shapes alone: an S
// whose group's buffer does not fit beside the walk, fp32 and other
// widths keep the old design below.
//
// The old design: a block owns a chunk of whole rays (about 768 points: 4
// fine rays of 192 samples or 12 coarse rays of 64), runs the forward walk
// of mlp_fwd.cuh over it in tiles of M points, and keeps the chunk's raw
// heads [4, chunk] in shared memory (12 KB) instead of writing them to
// device memory; one thread per ray then composites them
// (mlp_common.cuh::composite_ray, the compositing of the one-pass train
// kernel) and writes the six rows. Rounding as the forward kernel; no
// cross-block work, so the output is deterministic (both designs).

#include "fwd_hopper.cuh"

namespace {

using mlp::bf16;
using mlp::Dims;

// Points of a chunk: whole rays, about 768 points.
__host__ __device__ inline int chunk_points(int seg) {
  return (seg < 768 ? 768 / seg : 1) * seg;
}

template <int M>
__host__ __device__ inline int chunk_rows(int seg) {
  return (chunk_points(seg) + M - 1) / M * M;
}

template <typename T, int M>
size_t smem_bytes(const Dims& d, int seg) {
  return mlp::fwd_smem_bytes<T, M>(d) +
         4 * sizeof(float) * chunk_rows<M>(seg);
}

template <typename T, int M>
__global__ void __launch_bounds__(mlp::kThreads, 1)
    render_level_kernel(const float* __restrict__ pts,
                        const float* __restrict__ views,
                        const float* __restrict__ z,
                        const float* __restrict__ dn,
                        const T* __restrict__ w, const float* __restrict__ b,
                        float* __restrict__ out, int n_rays, int seg,
                        int white, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cpts = chunk_points(seg), rows = chunk_rows<M>(seg);
  float* craw = reinterpret_cast<float*>(smem + mlp::fwd_smem_bytes<T, M>(d));
  const int n = n_rays * seg, base = blockIdx.x * cpts;
  const int valid = min(cpts, n - base);
  for (int r0 = 0; r0 < valid; r0 += M)
    mlp::fwd_tile<T, M, mlp::NerfEnc>(pts, nullptr, views, w, b, n, base + r0,
                                      min(M, valid - r0), d, smem, craw,
                                      (size_t)rows, (size_t)r0);
  const int ray0 = blockIdx.x * (cpts / seg);
  const size_t np = (size_t)n;
  for (int r = threadIdx.x; r < valid / seg; r += mlp::kThreads) {
    const int ray = ray0 + r;
    float rgb[3], dep, acc;
    mlp::composite_ray(craw + r * seg, rows, z + (size_t)ray * seg, dn[ray],
                       seg, white != 0, nullptr, out, np,
                       (size_t)ray * seg, rgb, dep, acc);
  }
}

template <typename T, int M>
int launch(const void* pts, const void* views, const void* z, const void* dn,
           const void* w, const void* b, void* out, int n_rays, int seg,
           int white, const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, M>(d, seg);
  cudaError_t err = cudaFuncSetAttribute(
      render_level_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rays_per_chunk = chunk_points(seg) / seg;
  const int grid = (n_rays + rays_per_chunk - 1) / rays_per_chunk;
  render_level_kernel<T, M><<<grid, mlp::kThreads, smem, stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(views),
      static_cast<const float*>(z), static_cast<const float*>(dn),
      static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), n_rays, seg, white, d);
  return (int)cudaGetLastError();
}

// Points of #4's group on the Hopper walk: lcm(seg, 128), whole rays in
// whole tiles (capped where no buffer of it could fit).
long long group_points(int seg) {
  int a = seg, b = mlp::kFhTile;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const long long gp = (long long)seg / a * mlp::kFhTile;
  return gp < (1 << 20) ? gp : 0;
}

int hopper_plan(const Dims& d, int n_rays, int seg, bool bf16_,
                mlp::FhPlan* pl) {
  const long long gp = group_points(seg);
  return mlp::fh_plan(d, n_rays * seg, bf16_,
                      gp > 0 && mlp::fh_nerf_instance(d), pl, (int)gp);
}

}  // namespace

// The walk #4 takes at these shapes: out[0] the Hopper walk (1) or the old
// kernel (0), then points, tiles and rays a group (the old kernel: a
// chunk's points, 0, its rays), shared memory bytes, blocks, ring slots
// (0: the old kernel), groups (chunks). Returns a cudaError_t.
extern "C" int render_level_plan(int n_rays, int seg, int depth, int width,
                                 int skip_mask, int multires,
                                 int multires_views, int use_bf16,
                                 long long* out) {
  const Dims d(depth, width, skip_mask, multires, multires_views);
  mlp::FhPlan pl;
  const int err = hopper_plan(d, n_rays, seg, use_bf16, &pl);
  if (err) return err;
  if (pl.ok) {
    const long long slots[8] = {1, pl.gp, pl.gt, pl.gp / seg, pl.smem,
                                pl.grid, pl.stages,
                                (pl.tiles + pl.gt - 1) / pl.gt};
    for (int i = 0; i < 8; ++i) out[i] = slots[i];
    return 0;
  }
  const int per = chunk_points(seg) / seg;
  const long long slots[8] = {
      0, chunk_points(seg), 0, per,
      (long long)(use_bf16 ? smem_bytes<bf16, 128>(d, seg)
                           : smem_bytes<float, 64>(d, seg)),
      (n_rays + per - 1) / per, 0, (n_rays + per - 1) / per};
  for (int i = 0; i < 8; ++i) out[i] = slots[i];
  return 0;
}

// pts, views: [3, n_rays*seg]; z: [n_rays*seg]; dn: [n_rays]; out:
// [6, n_rays*seg]; all fp32. w: packed weights (bf16 when use_bf16, else
// fp32); b: packed fp32 biases (ops/fused_mlp_v2.py::pack). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int render_level(const void* pts, const void* views, const void* z,
                            const void* dn, const void* w, const void* b,
                            void* out, int n_rays, int seg, int depth,
                            int width, int skip_mask, int multires,
                            int multires_views, int white_bkgd, int use_bf16,
                            void* stream) {
  if (n_rays <= 0) return 0;
  const Dims d(depth, width, skip_mask, multires, multires_views);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp::FhPlan pl;
  const int err = hopper_plan(d, n_rays, seg, use_bf16, &pl);
  if (err) return err;
  if (pl.ok)
    return mlp::fh_nerf_launch<mlp::kFhRender>(
        pl, pts, views, w, b, out, n_rays * seg, d, s,
        mlp::FhRays{static_cast<const float*>(z),
                    static_cast<const float*>(dn), n_rays, seg, white_bkgd});
  if (use_bf16)
    return launch<bf16, 128>(pts, views, z, dn, w, b, out, n_rays, seg,
                             white_bkgd, d, s);
  return launch<float, 64>(pts, views, z, dn, w, b, out, n_rays, seg,
                           white_bkgd, d, s);
}
