// Shared device code of the MLP train kernels: the forward walk that
// saves every activation, the backward walk, and the dW accumulation.
//
// These kernels include this header, each with an encoder policy
// (mlp_common.cuh: NerfEnc or MipEnc); the bf16 path of modes 3 and 4
// and of the mode-2 kernels #2, #7, #11, #14 and #16 at widths up to 256,
// and the fp32 path of #3, #2 and #11 there, run level_train.cuh's walk
// instead (wgmma products, the dW as a GEMM over the launch); the fp32
// path of #5, #7, #14 and #16 and the shapes past the walk's run this one:
//   fused_mlp_bwd.cu      (replaces consistentnerf_tpu/ops/fused_mlp_v2.py::
//                          _bwd_pallas_T) and
//   fused_mip_bwd.cu      (ops/fused_mip.py::_bwd_pallas_T): weight grads
//                          of the MLP for a given output cotangent g [4, N]
//                          (mode 2);
//   onepass_level.cu      (ops/fused_onepass.py::onepass_level_T, mode 3)
//                          and
//   onepass_mip_level.cu  (ops/fused_onepass.py::onepass_mip_level_T,
//                          mode 4): forward, compositing, per-ray loss
//                          cotangent and backward of one sampling level.
//   fused_mip_fwd.cu      (ops/fused_mip.py::fused_mip_mlp_normals_T,
//                          mode 5): the MipMLP forward and
//                          d(raw density)/d(means), the normals' gradient.
// Modes 3 and 4 are mode 2 with the cotangent made in the kernel; they
// differ in their compositing (vanilla alpha compositing, or mip-NeRF's
// softplus density with exp(-cumsum) transmittance and distance_mean).
// Mode 5 runs the same forward, writes the raw heads, and then walks the
// density head's weights back through the trunk's ReLUs into the IPE
// (JAX: fused_mip.py::_mip_density_dmeans): per trunk layer i from the
// last down, g_pre = g_h [act_i > 0] rounded to the compute type, the
// encoding's gradient g_sc += g_pre W_sc^T where layer i reads the
// encoding (layer 0 and the post-skip layer), g_h = g_pre W_h^T; then
// through the IPE's Jacobian, d feature / d mean = 2^k damp cos(y). No dW.
//
// Bound: operations. One point costs 3x the forward's 1,186,816 FLOP
// (forward, input-grad products, dW products) at 8x256 / multires 10+4,
// against ~40 bytes of input and output. Where the TPU kernel kept the
// activations in VMEM, an H100 block has 227 KB of shared memory and one
// point's activations take ~9.9 KB (bf16, with the gradients), so:
//
//   * Work unit = a chunk of ~768 points (whole rays for the one-pass
//     kernel: 4 fine or 12 coarse rays). A persistent grid of one block
//     per SM walks the chunks; a block owns a workspace in device memory
//     (allocated by the wrapper) holding the chunk's PE, every layer's
//     activations and every layer's rounded gradients.
//   * Forward and backward run over sub-tiles of M points (64 in bf16,
//     32 in fp32) whose operands sit in shared memory, exactly like the
//     forward kernel (fused_mlp_fwd.cu); each layer's output tile is also
//     written to the workspace. We store rather than recompute: the store
//     is ~20 KB per point of L2/HBM traffic, the recompute would be
//     another full forward (1.19 MFLOP per point, the larger cost at the
//     kernel's present rate).
//   * dW = A^T G contracts over points. After a chunk's backward, every
//     dW block is read from the block's fp32 partial into registers,
//     accumulated over the chunk's 768 points streamed through shared
//     memory in 64-point slabs (A used column-major), and written back:
//     2 x 2.4 MB of partial traffic per 768 points. No atomics: each partial element has one owner warp and the
//     chunks of a block run in order, and a second launch
//     (mlp_train_reduce) sums the per-block partials in block order, so
//     the result is the same from run to run on a card.
//   * Bias grads are fp32 column sums of the unrounded gradients, one
//     owner thread per column.
//
// Rounding follows the JAX kernel (_aligned_backward_from_res): at bf16
// the output cotangent and every pre-activation gradient are rounded to
// bf16 for the products (dW and the input gradient), bias grads sum the
// fp32 values, ReLU masks come from the saved bf16 activations.
//
// Packed weight layout: ops/fused_mlp_v2.py::pack (the forward kernel's).
// The dW and db partials use the same packed layout, in fp32.

#pragma once

#include <algorithm>

#include "mlp_common.cuh"

namespace mlp {

constexpr int kChunk = 768;  // points per chunk (before whole-ray rounding)

__host__ __device__ inline int pad64(int x) { return (x + 63) / 64 * 64; }

template <typename T> struct SubTile;
template <> struct SubTile<bf16> { static constexpr int M = 64; };
template <> struct SubTile<float> { static constexpr int M = 32; };

// Workspace of one block: column-block arrays of [rows, cols] row-major.
template <typename T>
struct Workspace {
  T *pe, *ve, *act, *feat, *hv, *gpre, *gfeat, *ghv, *graw;
  int rows;  // chunk rows (multiple of 64)
  __device__ Workspace(T* base, const Dims& d, int r) : rows(r) {
    size_t o = 0;
    pe = base + o; o += (size_t)r * d.P;
    ve = base + o; o += (size_t)r * d.V;
    act = base + o; o += (size_t)r * d.depth * d.width;
    feat = base + o; o += (size_t)r * d.width;
    hv = base + o; o += (size_t)r * d.half;
    gpre = base + o; o += (size_t)r * d.depth * d.width;
    gfeat = base + o; o += (size_t)r * d.width;
    ghv = base + o; o += (size_t)r * d.half;
    graw = base + o;
  }
  __device__ T* act_l(int i, const Dims& d) const {
    return act + (size_t)i * rows * d.width;
  }
  __device__ T* gpre_l(int i, const Dims& d) const {
    return gpre + (size_t)i * rows * d.width;
  }
};

// ---------------------------------------------------------------------------
// Backward pieces
// ---------------------------------------------------------------------------

// out[m, k] = sum_{n < n_red} g[m, n] * Wt[k * ldw + n] for k < k_out, into
// fp32 shared memory (ldo); with ACC the sum is added to out. Wt is a
// layer's packed W^T [K, N=ldw], so its transpose is read column-major.
template <int M, bool ACC = false>
__device__ void grad_product(const bf16* g, int ldg, int n_red,
                            const bf16* __restrict__ wt, int ldw, int k_out,
                            float* out, int ldo) {
  constexpr int RT = M / 16;
  const int warp = threadIdx.x / 32;
  for (int kt = warp; kt < k_out / 16; kt += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (ACC)
        wmma::load_matrix_sync(acc[r], out + r * 16 * ldo + kt * 16, ldo,
                               wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[r], 0.0f);
    }
    for (int n0 = 0; n0 < n_red; n0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, wt + (size_t)kt * 16 * ldw + n0, ldw);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, g + r * 16 * ldg + n0, ldg);
        wmma::mma_sync(acc[r], a, b, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      wmma::store_matrix_sync(out + r * 16 * ldo + kt * 16, acc[r], ldo,
                              wmma::mem_row_major);
  }
}

template <int M, bool ACC = false>
__device__ void grad_product(const float* g, int ldg, int n_red,
                            const float* __restrict__ wt, int ldw, int k_out,
                            float* out, int ldo) {
  constexpr int RI = M / 16;
  constexpr int CJ = 8;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < k_out; k0 += 16 * CJ) {
    float acc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < n_red; ++n) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = g[(ty + 16 * i) * ldg + n];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int k = k0 + tx + 16 * j;
        b[j] = k < k_out ? wt[(size_t)k * ldw + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int k = k0 + tx + 16 * j;
        if (k < k_out) {
          float* o = out + (ty + 16 * i) * ldo + k;
          *o = ACC ? *o + acc[i][j] : acc[i][j];
        }
      }
  }
}

// part[k, n] += sum_{p < rows} a[p, k] * g[p, n] for k < K, n < N: one
// dW block (row-major [K, N] fp32, its packed position). Per 64-column
// block of the output (and 256-row block of K), each warp keeps its
// output tiles in registers while the chunk's points stream through
// shared memory in 64-point slabs (A slab [64, kb], G slab [64, nb],
// 16-byte copies); A is read column-major from the slab. Each output tile
// has one owner warp. `sbuf` is free shared memory of at least
// kDwStageBytes.
constexpr int kDwSlab = 64, kDwNB = 64, kDwKB = 256, kDwTiles = 8;
constexpr size_t kDwStageBytes =
    (size_t)kDwSlab * (kDwKB + 8 + kDwNB + 8) * sizeof(bf16);

__device__ void dw_accumulate(const bf16* a, int lda, int K, const bf16* g,
                              int N, int rows, float* part, bf16* sbuf) {
  const int warp = threadIdx.x / 32;
  bf16* sa = sbuf;                                // [kDwSlab][kb + 8]
  bf16* sg = sbuf + kDwSlab * (kDwKB + 8);        // [kDwSlab][nb + 8]
  for (int k0 = 0; k0 < K; k0 += kDwKB) {
    const int kb = min(kDwKB, K - k0), lsa = kb + 8;
    for (int n0 = 0; n0 < N; n0 += kDwNB) {
      const int nb = min(kDwNB, N - n0), lsg = nb + 8;
      const int ntn = nb / 16, tiles = (kb / 16) * ntn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kDwTiles];
#pragma unroll
      for (int f = 0; f < kDwTiles; ++f) {
        const int t = warp + f * kWarps;
        if (t < tiles)
          wmma::load_matrix_sync(
              acc[f], part + (size_t)(k0 + (t / ntn) * 16) * N + n0 +
                          (t % ntn) * 16,
              N, wmma::mem_row_major);
      }
      for (int p0 = 0; p0 < rows; p0 += kDwSlab) {
        __syncthreads();
        for (int e = threadIdx.x; e < kDwSlab * kb / 8; e += kThreads) {
          const int r = e / (kb / 8), c = (e % (kb / 8)) * 8;
          *reinterpret_cast<uint4*>(sa + r * lsa + c) =
              *reinterpret_cast<const uint4*>(a + (size_t)(p0 + r) * lda +
                                              k0 + c);
        }
        for (int e = threadIdx.x; e < kDwSlab * nb / 8; e += kThreads) {
          const int r = e / (nb / 8), c = (e % (nb / 8)) * 8;
          *reinterpret_cast<uint4*>(sg + r * lsg + c) =
              *reinterpret_cast<const uint4*>(g + (size_t)(p0 + r) * N +
                                              n0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int pp = 0; pp < kDwSlab; pp += 16) {
#pragma unroll
          for (int f = 0; f < kDwTiles; ++f) {
            const int t = warp + f * kWarps;
            if (t < tiles) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::col_major> fa;
              wmma::load_matrix_sync(fa, sa + pp * lsa + (t / ntn) * 16,
                                     lsa);
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major> fb;
              wmma::load_matrix_sync(fb, sg + pp * lsg + (t % ntn) * 16,
                                     lsg);
              wmma::mma_sync(acc[f], fa, fb, acc[f]);
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < kDwTiles; ++f) {
        const int t = warp + f * kWarps;
        if (t < tiles)
          wmma::store_matrix_sync(
              part + (size_t)(k0 + (t / ntn) * 16) * N + n0 +
                  (t % ntn) * 16,
              acc[f], N, wmma::mem_row_major);
      }
      __syncthreads();
    }
  }
}

__device__ void dw_accumulate(const float* a, int lda, int K,
                              const float* g, int N, int rows, float* part,
                              float*) {
  constexpr int RI = 4, CJ = 8;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += 16 * RI)
    for (int n0 = 0; n0 < N; n0 += 16 * CJ) {
      float acc[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
      for (int p = 0; p < rows; ++p) {
        float av[RI], gv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int k = k0 + ty + 16 * i;
          av[i] = k < K ? a[(size_t)p * lda + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int n = n0 + tx + 16 * j;
          gv[j] = n < N ? g[(size_t)p * N + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (k < K && n < N) part[(size_t)k * N + n] += acc[i][j];
        }
    }
}

// Copy an [M, cols] shared tile (ld) into workspace rows [row0, row0 + M).
template <typename T, int M>
__device__ void save_tile(const T* src, int ld, int cols, T* dst,
                          int row0) {
  for (int e = threadIdx.x; e < M * cols; e += kThreads) {
    const int p = e / cols, c = e % cols;
    dst[(size_t)(row0 + p) * cols + c] = src[p * ld + c];
  }
}

// Shared memory of one block, in bytes (must match the carve-up below).
template <typename T>
__host__ __device__ size_t smem_bytes(const Dims& d, int rows, int mode) {
  constexpr int M = SubTile<T>::M;
  const size_t elems = (size_t)M * (d.P + kPad) + (size_t)M * (d.V + kPad) +
                       2 * (size_t)M * (d.act_cols() + kPad);
  // Mode 5 adds the encoding's fp32 gradient [M, P + 4].
  const size_t floats = (size_t)M * (d.width + 4) + kWarps * 256 + 4 * M +
                        5 * (size_t)rows +
                        (mode == 5 ? (size_t)M * (d.P + 4) : 0);
  // The dW pass reuses all of it as its bf16 staging buffer.
  const size_t total = elems * sizeof(T) + floats * sizeof(float);
  const size_t stage = sizeof(T) == sizeof(bf16) ? kDwStageBytes : 0;
  return total > stage ? total : stage;
}

// Rows of a chunk: modes 2 (plain MLP backward) and 5 (normals) take
// kChunk points; modes 3 and 4 (one-pass levels) whole rays of `seg`
// samples.
__host__ __device__ inline int chunk_points(int mode, int seg) {
  if (mode == 2 || mode == 5) return kChunk;
  const int rays = max(1, kChunk / seg);
  return rays * seg;
}

// Per-ray inputs of the one-pass levels (modes 3 and 4). Mode 3 reads z
// and dn; mode 4 reads tmid, delta, noise (may be null) per point and
// tlo, thi per ray, and the head constants.
struct RayRows {
  const float *z, *dn, *crgb, *tgt, *cd, *prior;
  const float *tmid, *delta, *noise, *tlo, *thi;
  float* out;  // [6, n_rays * seg]
  int n_rays, seg, white;
  float rgb_scale, rgb_padding, density_bias;
};

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// jax.nn.softplus: logaddexp(x, 0).
__device__ inline float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Mode 3: vanilla compositing of one chunk's whole rays (composite_ray),
// the per-ray loss cotangent and the compositing VJP. craw [4][rows]
// holds the raw heads on entry and d_raw on exit; ctrans [rows] the
// transmittance; one thread walks one ray forward, then back.
__device__ inline void vanilla_composite(const RayRows& rr, int c, int cpts,
                                         int rows, float* craw,
                                         float* ctrans) {
  const int S = rr.seg, R = cpts / S;
  const int ray0 = c * R;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int ray = ray0 + r;
    float* rw = craw + r * S;
    float* tr = ctrans + r * S;
    if (ray >= rr.n_rays) {
      for (int i = 0; i < S; ++i)
        for (int k = 0; k < 4; ++k) rw[k * rows + i] = 0.f;
      continue;
    }
    const float* z = rr.z + (size_t)ray * S;
    const float dn = rr.dn[ray];
    const size_t np = (size_t)rr.n_rays * S, pt0 = (size_t)ray * S;
    float acc, dep, rgb[3];
    composite_ray(rw, rows, z, dn, S, rr.white, tr, rr.out, np, pt0, rgb,
                  dep, acc);
    float d_rgb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d_rgb[k] = rr.crgb[ray] * (rgb[k] - rr.tgt[(size_t)k * rr.n_rays +
                                                ray]);
    const float d_dep = rr.cd[ray] * (dep - rr.prior[ray]);
    const float d_acc = rr.white ? -(d_rgb[0] + d_rgb[1] + d_rgb[2])
                                 : 0.f;
    float suffix = 0.f;
    for (int i = S - 1; i >= 0; --i) {
      const float dist = (i == S - 1 ? 1e10f : z[i + 1] - z[i]) * dn;
      const float sigma = rw[3 * rows + i];
      const float alpha = 1.f - expf(-fmaxf(sigma, 0.f) * dist);
      const float v = fmaxf(1.f - alpha, 1e-10f);
      const float trans = tr[i];
      const float w = alpha * trans;
      float cc[3], d_w = d_dep * z[i] + d_acc;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        cc[k] = 1.f / (1.f + expf(-rw[k * rows + i]));
        d_w += d_rgb[k] * cc[k];
      }
      const float d_alpha = d_w * trans - suffix / v;
      suffix += d_w * w;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rw[k * rows + i] = w * d_rgb[k] * cc[k] * (1.f - cc[k]);
      rw[3 * rows + i] =
          sigma > 0.f ? d_alpha * (1.f - alpha) * dist : 0.f;
    }
  }
  for (int e = R * S + threadIdx.x; e < rows; e += kThreads)
    for (int k = 0; k < 4; ++k) craw[k * rows + e] = 0.f;
  __syncthreads();
}

// Mode 4: mip compositing of one chunk's whole rays and the compositing
// VJP (fused_onepass.py:307-371). craw [4][rows] holds the raw heads on
// entry and d_raw on exit; ctrans [rows] the transmittance; one thread
// walks one ray forward, then back.
__device__ inline void mip_composite(const RayRows& rr, int c, int cpts, int rows,
                              float* craw, float* ctrans) {
  const int S = rr.seg, R = cpts / S;
  const int ray0 = c * R;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int ray = ray0 + r;
    float* rw = craw + r * S;
    float* tr = ctrans + r * S;
    if (ray >= rr.n_rays) {
      for (int i = 0; i < S; ++i)
        for (int k = 0; k < 4; ++k) rw[k * rows + i] = 0.f;
      continue;
    }
    const size_t np = (size_t)rr.n_rays * S, pt0 = (size_t)ray * S;
    const float* tmid = rr.tmid + pt0;
    const float* delta = rr.delta + pt0;
    const float* noise = rr.noise ? rr.noise + pt0 : nullptr;
    const float tlo = rr.tlo[ray], thi = rr.thi[ray];
    float csum = 0.f, acc = 0.f, swt = 0.f, rgb[3] = {0.f, 0.f, 0.f};
    for (int i = 0; i < S; ++i) {
      float xd = rw[3 * rows + i] + rr.density_bias;
      if (noise) xd += noise[i];
      const float dd = softplus(xd) * delta[i];
      const float alpha = 1.f - expf(-dd);
      const float trans = expf(-csum);
      const float w = alpha * trans;
      csum += dd;
      tr[i] = trans;
      acc += w;
      swt += w * tmid[i];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[k] += w * (sigmoid(rw[k * rows + i]) * rr.rgb_scale -
                       rr.rgb_padding);
      rr.out[5 * np + pt0 + i] = w;
    }
    if (rr.white)
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k] += 1.f - acc;
    const float acc_s = fmaxf(acc, 1e-37f);
    const bool valid = acc > 0.f;
    // acc == 0: 0/0 -> nan -> inf -> clipped to thi in the XLA chain.
    const float dist_u = valid ? swt / acc_s : thi;
    const float dist = fminf(fmaxf(dist_u, tlo), thi);
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rr.out[k * np + pt0 + i] = rgb[k];
      rr.out[3 * np + pt0 + i] = dist;
      rr.out[4 * np + pt0 + i] = acc;
    }
    float d_rgb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d_rgb[k] = rr.crgb[ray] * (rgb[k] - rr.tgt[(size_t)k * rr.n_rays +
                                                ray]);
    const float d_dist = rr.cd[ray] * (dist - rr.prior[ray]);
    const float d_acc = rr.white ? -(d_rgb[0] + d_rgb[1] + d_rgb[2]) : 0.f;
    // The clip passes the cotangent only strictly inside its range.
    const float d_su =
        (dist_u > tlo && dist_u < thi && valid) ? d_dist : 0.f;
    float suffix = 0.f;
    for (int i = S - 1; i >= 0; --i) {
      float xd = rw[3 * rows + i] + rr.density_bias;
      if (noise) xd += noise[i];
      const float dd = softplus(xd) * delta[i];
      const float alpha = 1.f - expf(-dd);
      const float trans = tr[i];
      const float w = alpha * trans;
      float s[3], d_w = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] = sigmoid(rw[k * rows + i]);
        d_w += d_rgb[k] * (s[k] * rr.rgb_scale - rr.rgb_padding);
      }
      d_w += d_su * (tmid[i] - dist_u) / acc_s + d_acc;
      // w_i = alpha_i trans_i, trans_i = exp(-sum_{j<i} dd_j):
      // d/d dd_i = d_w_i trans_i e^{-dd_i} - sum_{j>i} d_w_j w_j.
      const float d_dd = d_w * trans * (1.f - alpha) - suffix;
      suffix += d_w * w;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rw[k * rows + i] =
            w * d_rgb[k] * rr.rgb_scale * s[k] * (1.f - s[k]);
      rw[3 * rows + i] = d_dd * delta[i] * sigmoid(xd);
    }
  }
  for (int e = R * S + threadIdx.x; e < rows; e += kThreads)
    for (int k = 0; k < 4; ++k) craw[k * rows + e] = 0.f;
  __syncthreads();
}

// One block's walk over its chunks. mode 2: g [4, n] is the output
// cotangent. modes 3 (vanilla) and 4 (mip): compositing and the loss
// cotangent make it. mode 5: the raw heads and the density's gradient by
// the means go to rr.out [7, n]; no dW (part_all may be null). `covs` is
// read by the mip encoder only. L: the layout of the point streams and of
// g (mlp_common.cuh); the row-major layout serves mode 2 only. V1 compiles
// in the heads on [pe | h] (the v1 kernels; Dims::head_skip).
template <typename T, int MODE, typename Enc, typename L = ColMajor,
          bool V1 = false>
__device__ void train_block(const float* __restrict__ pts,
                            const float* __restrict__ covs,
                            const float* __restrict__ views,
                            const float* __restrict__ gin, RayRows rr,
                            const T* __restrict__ wflat,
                            const float* __restrict__ bflat, T* ws_all,
                            float* part_all, size_t part_stride, int n,
                            Dims d) {
  constexpr int M = SubTile<T>::M;
  static_assert(!L::kRow || MODE == 2, "row-major streams: mode 2 only");
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = d.width, H = d.half, P = d.P, V = d.V;
  const int cpts = chunk_points(MODE, rr.seg);
  const int rows = pad64(cpts);
  const int ldp = P + kPad, ldv = V + kPad, ldh = d.act_cols() + kPad;
  const int ldf = W + 4;
  T* pe = reinterpret_cast<T*>(smem);
  T* ve = pe + M * ldp;
  T* hx = ve + M * ldv;
  T* hy = hx + M * ldh;
  float* gf = reinterpret_cast<float*>(hy + M * ldh);
  float* stage_all = gf + M * ldf;
  float* stage = stage_all + (threadIdx.x / 32) * 256;
  float* graw = stage_all + kWarps * 256;  // [4][M]
  float* craw = graw + 4 * M;              // [4][rows] raw, then d_raw
  float* ctrans = craw + 4 * rows;         // [rows]
  float* gsc = ctrans + rows;              // mode 5: [M][P + 4]
  const int ldsc = P + 4;

  T* ws_base = ws_all + (size_t)blockIdx.x * rows * d.ws_cols();
  Workspace<T> ws(ws_base, d, rows);
  float* part = MODE == 5 ? nullptr : part_all + blockIdx.x * part_stride;
  float* pb = MODE == 5 ? nullptr : part + d.template w_total<V1>();

  if (MODE != 5)
    for (size_t j = threadIdx.x; j < part_stride; j += kThreads) part[j] = 0.f;
  __syncthreads();

  const T* w_f = wflat + d.w_feature();
  const T* w_v = wflat + d.template w_views<V1>();
  const T* w_a = wflat + d.template w_alpha<V1>();
  const T* w_r = wflat + d.template w_rgb<V1>();
  // The heads read h, or [pe | h] after a skip at the last trunk layer
  // (the v1 kernels); their h rows start at row hoff.
  const bool hs = V1 && d.head_skip();
  const int hoff = hs ? P : 0;
  const int n_chunks = (n + cpts - 1) / cpts;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int base = c * cpts;
    const int valid = min(cpts, n - base);

    // ---- forward over sub-tiles, saving every activation ----
    for (int r0 = 0; r0 < rows; r0 += M) {
      const int sub_valid = max(0, min(M, valid - r0));
      encode_tile<T, M, Enc, L>(pts, covs, views, n, base + r0, sub_valid,
                                d, pe, ldp, ve, ldv, stage_all);
      __syncthreads();
      save_tile<T, M>(pe, ldp, P, ws.pe, r0);
      save_tile<T, M>(ve, ldv, V, ws.ve, r0);
      const T* w = wflat;
      const float* b = bflat;
      T* h = nullptr;
      for (int i = 0; i < d.depth; ++i) {
        Seg<T> s0, s1 = {nullptr, 0, 0};
        if (i == 0) {
          s0 = {pe, ldp, P};
        } else if (d.skip_before(i)) {
          s0 = {pe, ldp, P};
          s1 = {h, ldh, W};
        } else {
          s0 = {h, ldh, W};
        }
        T* dst = (h == hx) ? hy : hx;
        layer<M>(s0, s1, w, W, b, true, dst, ldh, stage);
        __syncthreads();
        save_tile<T, M>(dst, ldh, W, ws.act_l(i, d), r0);
        h = dst;
        w += (size_t)d.rows(i) * W;
        b += W;
      }
      if (MODE >= 3) {  // alpha head, fp32, before h is overwritten
        for (int p = threadIdx.x; p < M; p += kThreads) {
          float s = 0.f;
          if (hs)
            for (int k = 0; k < P; ++k)
              s = fmaf(to_f(pe[p * ldp + k]), to_f(w_a[k]), s);
          for (int k = 0; k < W; ++k)
            s = fmaf(to_f(h[p * ldh + k]), to_f(w_a[hoff + k]), s);
          craw[3 * rows + r0 + p] = s + bflat[d.b_alpha()];
        }
      }
      T* feat = (h == hx) ? hy : hx;
      layer<M>(hs ? Seg<T>{pe, ldp, P} : Seg<T>{h, ldh, W},
               hs ? Seg<T>{h, ldh, W} : Seg<T>{nullptr, 0, 0}, w_f, W,
               bflat + d.b_feature(), false, feat, ldh, stage);
      __syncthreads();
      save_tile<T, M>(feat, ldh, W, ws.feat, r0);
      layer<M>(Seg<T>{feat, ldh, W}, Seg<T>{ve, ldv, V}, w_v, H,
               bflat + d.b_views(), true, h, ldh, stage);
      __syncthreads();
      save_tile<T, M>(h, ldh, H, ws.hv, r0);
      if (MODE >= 3) {
        for (int e = threadIdx.x; e < 3 * M; e += kThreads) {
          const int p = e % M, cc = e / M;
          float s = 0.f;
          for (int k = 0; k < H; ++k)
            s = fmaf(to_f(h[p * ldh + k]), to_f(w_r[cc * H + k]), s);
          craw[cc * rows + r0 + p] = s + bflat[d.b_rgb() + cc];
        }
      }
      __syncthreads();
    }

    // ---- one-pass: compositing and the per-ray loss cotangent ----
    if (MODE == 3) vanilla_composite(rr, c, cpts, rows, craw, ctrans);
    if (MODE == 4) mip_composite(rr, c, cpts, rows, craw, ctrans);

    // ---- mode 5: the raw heads, then d(raw density)/d(means) ----
    if (MODE == 5) {
      for (int e = threadIdx.x; e < 4 * valid; e += kThreads) {
        const int k = e / valid, p = e % valid;
        rr.out[(size_t)k * n + base + p] = craw[k * rows + p];
      }
      for (int r0 = 0; r0 < valid; r0 += M) {
        for (int e = threadIdx.x; e < M * P; e += kThreads)
          gsc[(e / P) * ldsc + e % P] = 0.f;
        T* cur = hx;
        for (int i = d.depth - 1; i >= 0; --i) {
          const T* act = ws.act_l(i, d);
          for (int e = threadIdx.x; e < M * W; e += kThreads) {
            const int p = e / W, j = e % W;
            float v = i == d.depth - 1 ? to_f(w_a[hoff + j])
                                       : gf[p * ldf + j];
            if (!(to_f(act[(size_t)(r0 + p) * W + j]) > 0.f)) v = 0.f;
            cur[p * ldh + j] = from_f<T>(v);
          }
          __syncthreads();
          if (i == 0 || d.skip_before(i))  // the encoding's rows come first
            grad_product<M, true>(cur, ldh, W, wflat + d.w_layer(i), W, P,
                                  gsc, ldsc);
          if (i > 0) {
            const size_t off = d.skip_before(i) ? (size_t)P * W : 0;
            grad_product<M>(cur, ldh, W, wflat + d.w_layer(i) + off, W, W, gf,
                            ldf);
          }
          __syncthreads();
          cur = (cur == hx) ? hy : hx;
        }
        // Feature 3k + r is sin(y) damp, feature 3F + 3k + r sin(y + pi/2)
        // damp, with y = mean_r 2^k (mlp_common.cuh::encode_ipe).
        const int F = d.multires;
        for (int e = threadIdx.x; e < 3 * M; e += kThreads) {
          const int p = e / 3, r = e % 3;
          if (r0 + p >= valid) continue;
          const size_t g = (size_t)base + r0 + p;
          const float mean = pts[(size_t)r * n + g];
          const float cov = covs[(size_t)r * n + g];
          const float* gs = gsc + p * ldsc;
          float s = 0.f;
          for (int k = 0; k < F; ++k) {
            const float y = ldexpf(mean, k);
            const float damp = expf(-0.5f * ldexpf(cov, 2 * k));
            const float a = gs[3 * k + r] * damp * safe_cos(y);
            const float b =
                gs[3 * F + 3 * k + r] * damp * safe_cos(y + kHalfPi);
            s += ldexpf(a, k) + ldexpf(b, k);
          }
          rr.out[(size_t)(4 + r) * n + g] = s;
        }
        __syncthreads();
      }
      continue;
    }

    // ---- backward over sub-tiles ----
    for (int r0 = 0; r0 < rows; r0 += M) {
      for (int e = threadIdx.x; e < 4 * M; e += kThreads) {
        // Row-major: the sub-tile's 4M cotangents are contiguous; read
        // them point-major, one coalesced copy.
        const int k = L::kRow ? e % 4 : e / M, p = L::kRow ? e / 4 : e % M;
        const int g = base + r0 + p;
        float v;
        if (MODE >= 3) {
          v = craw[k * rows + r0 + p];
        } else {
          v = (r0 + p < valid) ? gin[L::at(k, g, n, 4)] : 0.f;
        }
        graw[k * M + p] = v;
        ws.graw[(size_t)(r0 + p) * 4 + k] = from_f<T>(v);
      }
      __syncthreads();
      if (threadIdx.x < 4) {  // rgb and alpha bias grads (fp32 sums)
        const int k = threadIdx.x;
        float s = 0.f;
        for (int p = 0; p < M; ++p) s += graw[k * M + p];
        pb[k < 3 ? d.b_rgb() + k : d.b_alpha()] += s;
      }
      // g_hv = (round(g_rgb) @ Wr) * (hv > 0)
      for (int j = threadIdx.x; j < H; j += kThreads) {
        float colsum = 0.f;
        for (int p = 0; p < M; ++p) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            v = fmaf(to_f(from_f<T>(graw[k * M + p])), to_f(w_r[k * H + j]),
                     v);
          if (!(to_f(ws.hv[(size_t)(r0 + p) * H + j]) > 0.f)) v = 0.f;
          colsum += v;
          const T vr = from_f<T>(v);
          hx[p * ldh + j] = vr;
          ws.ghv[(size_t)(r0 + p) * H + j] = vr;
        }
        pb[d.b_views() + j] += colsum;
      }
      __syncthreads();
      // g_feat = round(g_hv) @ Wv[feature rows]^T (no activation)
      grad_product<M>(hx, ldh, H, w_v, H, W, gf, ldf);
      __syncthreads();
      for (int j = threadIdx.x; j < W; j += kThreads) {
        float colsum = 0.f;
        for (int p = 0; p < M; ++p) {
          const float v = gf[p * ldf + j];
          colsum += v;
          const T vr = from_f<T>(v);
          hy[p * ldh + j] = vr;
          ws.gfeat[(size_t)(r0 + p) * W + j] = vr;
        }
        pb[d.b_feature() + j] += colsum;
      }
      __syncthreads();
      // g_h = round(g_feat) @ Wf^T + round(g_alpha) wa over the heads' h
      // rows (their pe rows give the encoding, which takes no grad), then
      // the trunk.
      grad_product<M>(hy, ldh, W, w_f + (size_t)hoff * W, W, W, gf, ldf);
      __syncthreads();
      T* cur = hx;
      for (int i = d.depth - 1; i >= 0; --i) {
        const T* act = ws.act_l(i, d);
        T* gp = ws.gpre_l(i, d);
        for (int j = threadIdx.x; j < W; j += kThreads) {
          float colsum = 0.f;
          for (int p = 0; p < M; ++p) {
            float v = gf[p * ldf + j];
            if (i == d.depth - 1)
              v = fmaf(to_f(from_f<T>(graw[3 * M + p])), to_f(w_a[hoff + j]),
                       v);
            if (!(to_f(act[(size_t)(r0 + p) * W + j]) > 0.f)) v = 0.f;
            colsum += v;
            const T vr = from_f<T>(v);
            cur[p * ldh + j] = vr;
            gp[(size_t)(r0 + p) * W + j] = vr;
          }
          pb[d.b_layer(i) + j] += colsum;
        }
        __syncthreads();
        if (i > 0) {
          const size_t off = d.skip_before(i) ? (size_t)P * W : 0;
          grad_product<M>(cur, ldh, W, wflat + d.w_layer(i) + off, W, W, gf,
                          ldf);
          __syncthreads();
          cur = (cur == hx) ? hy : hx;
        }
      }
    }

    // ---- dW over the chunk ----
    for (int i = 0; i < d.depth; ++i) {
      float* pw = part + d.w_layer(i);
      const T* g = ws.gpre_l(i, d);
      if (i == 0) {
        dw_accumulate(ws.pe, P, P, g, W, rows, pw, pe);
      } else if (d.skip_before(i)) {
        dw_accumulate(ws.pe, P, P, g, W, rows, pw, pe);
        dw_accumulate(ws.act_l(i - 1, d), W, W, g, W, rows,
                      pw + (size_t)P * W, pe);
      } else {
        dw_accumulate(ws.act_l(i - 1, d), W, W, g, W, rows, pw, pe);
      }
    }
    const T* h_last = ws.act_l(d.depth - 1, d);
    if (hs)
      dw_accumulate(ws.pe, P, P, ws.gfeat, W, rows, part + d.w_feature(),
                    pe);
    dw_accumulate(h_last, W, W, ws.gfeat, W, rows,
                  part + d.w_feature() + (size_t)hoff * W, pe);
    dw_accumulate(ws.feat, W, W, ws.ghv, H, rows,
                  part + d.template w_views<V1>(), pe);
    dw_accumulate(ws.ve, V, V, ws.ghv, H, rows,
                  part + d.template w_views<V1>() + (size_t)W * H, pe);
    for (int k = threadIdx.x; k < hoff + W; k += kThreads) {
      // Row k of the heads' input: pe column k, then h column k - hoff.
      const T* src = k < hoff ? ws.pe + k : h_last + (k - hoff);
      const int lds = k < hoff ? P : W;
      float s = 0.f;
      for (int p = 0; p < rows; ++p)
        s = fmaf(to_f(src[(size_t)p * lds]),
                 to_f(ws.graw[(size_t)p * 4 + 3]), s);
      part[d.template w_alpha<V1>() + k] += s;
    }
    for (int e = threadIdx.x; e < 3 * H; e += kThreads) {
      const int cc = e / H, j = e % H;
      float s = 0.f;
      for (int p = 0; p < rows; ++p)
        s = fmaf(to_f(ws.hv[(size_t)p * H + j]),
                 to_f(ws.graw[(size_t)p * 4 + cc]), s);
      part[d.template w_rgb<V1>() + e] += s;
    }
    __syncthreads();
  }
}

// dw[j] = sum over blocks b (in order) of part[b * stride + j].
__global__ void mlp_train_reduce(const float* __restrict__ part, int blocks,
                                 size_t stride, int total,
                                 float* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * stride + j];
  dw[j] = s;
}

// Grid, workspace and partial sizes of one launch. out[0] = blocks,
// out[1] = workspace elements per block, out[2] = partial floats per block.
template <typename T, bool V1 = false, typename K>
int plan(K kernel, int mode, int n, int seg, const Dims& d,
         long long* out) {
  const int cpts = chunk_points(mode, seg);
  const int rows = pad64(cpts);
  const size_t smem = smem_bytes<T>(d, rows, mode);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int chunks = (n + cpts - 1) / cpts;
  out[0] = std::min(chunks, sms * per_sm);
  out[1] = (long long)rows * (long long)d.ws_cols();
  out[2] = (d.template w_total<V1>() + d.template b_total<V1>() + 63) / 64 *
           64;
  out[3] = (long long)smem;
  return 0;
}

}  // namespace mlp
