// Shared device code of the MLP kernels: element conversions, the sizes
// and packed-weight offsets of one MLP config, the input encoders and the
// layer product (bf16 wmma with fp32 accumulators, or fp32 on the CUDA
// cores).
//
// The NeRFMLP and the MipMLP differ only in their encoders (and in the
// column order of the skip concat, which the packing absorbs:
// ops/fused_mlp_v2.py::pack lays every post-skip layer out as [pe | h]),
// so the walks in mlp_fwd.cuh and mlp_train.cuh take an encoder policy:
//   NerfEnc  torch-Embedder PE of points and view directions, in the
//            order [x, sin(2^k x), cos(2^k x), ...] (fused_mlp.py);
//   MipEnc   the IPE of the samples' Gaussians (means, diagonal covs):
//            [sin(y) (3F) | sin(y + pi/2) (3F)] * exp(-var 4^k / 2) with
//            y = x 2^k, frequency-major and coordinate-minor
//            (core/encoding.py::integrated_pos_enc), and the view
//            encoding [v, sin(v 2^k) (3D), sin(v 2^k + pi/2) (3D)]
//            (pos_enc with the identity).
// Both compute each feature in fp32 and then cast it to the compute type.
//
// Stream layouts. A walk reads its point streams (and the train walk its
// cotangent) in one of two layouts, a compile-time policy:
//   ColMajor  the transposed streams [rows, n]: element (r, p) at r n + p
//             (the JAX package's *_T kernels; every walk's default);
//   RowMajor  the row-major streams [n, rows]: element (r, p) at p rows + r
//             (the JAX _fwd_pallas / _bwd_pallas kernels). A tile's M
//             points are then 3M contiguous floats per stream: the walk
//             stages them into shared memory with one coalesced copy
//             (stage_rows) and encodes from there.
// The mip sine is core/mathx.py::safe_sin: arguments with |y| >= 100 pi
// are reduced by the floored remainder (fmodf, then + t where the sign
// differs, as jnp.remainder does), and the cosine half is sinf of
// y + pi/2 rounded in fp32, not cosf(y): at k = 8..15 the arguments pass
// 100 pi while the damping is still ~0.04, where either shortcut differs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // smem row padding (elements) against bank conflicts

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_f(float v);
template <> __device__ inline float from_f<float>(float v) { return v; }
template <> __device__ inline bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sizes of one MLP config. `ipe` selects the MipMLP's encodings (6F point
// features, no identity); `hv` is the view layer's width (the NeRFMLP's
// is width / 2, the MipMLP's 128 whatever its width).
struct Dims {
  int depth, width, half, skip_mask, multires, multires_views, ipe;
  int pe_real, ve_real, P, V;
  __host__ __device__ Dims(int d, int w, int sm, int mr, int mv, int ip = 0,
                           int hv = 0)
      : depth(d), width(w), half(hv > 0 ? hv : w / 2), skip_mask(sm),
        multires(mr), multires_views(mv), ipe(ip),
        pe_real(ip ? 6 * mr : 3 * (1 + 2 * mr)),
        ve_real(3 * (1 + 2 * mv)), P(pad16(ip ? 6 * mr : 3 * (1 + 2 * mr))),
        V(pad16(3 * (1 + 2 * mv))) {}
  // Columns of the shared activation buffers (trunk and view layer).
  __host__ __device__ int act_cols() const {
    return width > half ? width : half;
  }
  __host__ __device__ bool skip_before(int i) const {
    return i > 0 && ((skip_mask >> (i - 1)) & 1);
  }
  __host__ __device__ int rows(int i) const {  // K_pad of trunk layer i
    return i == 0 ? P : (skip_before(i) ? P + width : width);
  }
  // Packed weight offsets (elements).
  __host__ __device__ size_t w_layer(int i) const {
    size_t o = 0;
    for (int j = 0; j < i; ++j) o += (size_t)rows(j) * width;
    return o;
  }
  __host__ __device__ size_t w_feature() const { return w_layer(depth); }
  __host__ __device__ size_t w_views() const {
    return w_feature() + (size_t)width * width;
  }
  __host__ __device__ size_t w_alpha() const {
    return w_views() + (size_t)(width + V) * half;
  }
  __host__ __device__ size_t w_rgb() const { return w_alpha() + width; }
  __host__ __device__ size_t w_total() const { return w_rgb() + 3 * half; }
  // Packed bias offsets.
  __host__ __device__ int b_layer(int i) const { return i * width; }
  __host__ __device__ int b_feature() const { return depth * width; }
  __host__ __device__ int b_views() const { return b_feature() + width; }
  __host__ __device__ int b_alpha() const { return b_views() + half; }
  __host__ __device__ int b_rgb() const { return b_alpha() + 1; }
  __host__ __device__ int b_total() const { return b_rgb() + 3; }
  // Workspace columns per point: PE, VE, ACT[depth], FEAT, HV,
  // GPRE[depth], GFEAT, GHV, GRAW[4].
  __host__ __device__ size_t ws_cols() const {
    return (size_t)P + V + 2 * ((size_t)depth * width + width + half) + 4;
  }
};

struct ColMajor {
  static constexpr bool kRow = false;
  __host__ __device__ static size_t at(int r, size_t p, size_t n, int) {
    return (size_t)r * n + p;
  }
};

struct RowMajor {
  static constexpr bool kRow = true;
  __host__ __device__ static size_t at(int r, size_t p, size_t, int rows) {
    return p * rows + r;
  }
};

// Points [base, base + valid) of a row-major [n, rows] stream into dst
// [valid * rows]: one coalesced copy.
__device__ inline void stage_rows(const float* __restrict__ x, int rows,
                                  int base, int valid, float* dst) {
  const float* src = x + (size_t)base * rows;
  for (int e = threadIdx.x; e < valid * rows; e += kThreads) dst[e] = src[e];
}

template <typename T>
struct Seg {
  const T* buf;
  int ld;
  int k;
};

// ---------------------------------------------------------------------------
// Encoders
// ---------------------------------------------------------------------------

// Torch-Embedder PE of points [base, base + M) of the stream x (layout L,
// 3 rows) into dst [M, ld] (zero past 3(1+2nf) columns and past `valid`
// points).
template <typename T, int M, typename L = ColMajor>
__device__ void encode(const float* __restrict__ x, int n, int base,
                       int valid, int nf, int kpad, T* dst, int ld) {
  const int real = 3 * (1 + 2 * nf);
  for (int e = threadIdx.x; e < M * kpad; e += kThreads) {
    const int p = e / kpad, c = e % kpad, g = base + p;
    float v = 0.f;
    if (c < real && p < valid) {
      if (c < 3) {
        v = x[L::at(c, g, n, 3)];
      } else {
        const int j = c - 3, f = j / 6, r = j % 6;
        const float t = x[L::at(r % 3, g, n, 3)] * (float)(1 << f);
        v = r < 3 ? sinf(t) : cosf(t);
      }
    }
    dst[p * ld + c] = from_f<T>(v);
  }
}

constexpr float kTrigRange = 314.15926535897932f;  // 100 pi in fp32
constexpr float kHalfPi = 1.5707963267948966f;     // pi / 2 in fp32

// core/mathx.py::safe_sin: sinf of y, or of its floored remainder by
// 100 pi where |y| >= 100 pi.
__device__ inline float safe_sin(float y) {
  if (!(fabsf(y) < kTrigRange)) {
    float r = fmodf(y, kTrigRange);
    if (r != 0.f && r < 0.f) r += kTrigRange;
    y = r;
  }
  return sinf(y);
}

// IPE of the Gaussians at points [base, base + M) of the means / covs
// streams (layout L) into dst [M, ld] (zero past 6 nf columns and past
// `valid` points).
template <typename T, int M, typename L = ColMajor>
__device__ void encode_ipe(const float* __restrict__ mean,
                           const float* __restrict__ cov, int n, int base,
                           int valid, int nf, int kpad, T* dst, int ld) {
  const int half = 3 * nf, real = 6 * nf;
  for (int e = threadIdx.x; e < M * kpad; e += kThreads) {
    const int p = e / kpad, c = e % kpad, g = base + p;
    float v = 0.f;
    if (c < real && p < valid) {
      const int j = c < half ? c : c - half, k = j / 3, r = j % 3;
      float y = ldexpf(mean[L::at(r, g, n, 3)], k);
      if (c >= half) y += kHalfPi;
      const float var = ldexpf(cov[L::at(r, g, n, 3)], 2 * k);
      v = expf(-0.5f * var) * safe_sin(y);
    }
    dst[p * ld + c] = from_f<T>(v);
  }
}

// The MipMLP's view encoding [v, sin(v 2^k), sin(v 2^k + pi/2)] of the
// view-direction stream (layout L) into dst [M, ld].
template <typename T, int M, typename L = ColMajor>
__device__ void encode_mip_views(const float* __restrict__ x, int n,
                                 int base, int valid, int nf, int kpad,
                                 T* dst, int ld) {
  const int half = 3 * nf, real = 3 + 6 * nf;
  for (int e = threadIdx.x; e < M * kpad; e += kThreads) {
    const int p = e / kpad, c = e % kpad, g = base + p;
    float v = 0.f;
    if (c < real && p < valid) {
      if (c < 3) {
        v = x[L::at(c, g, n, 3)];
      } else {
        const int j = c - 3, jj = j < half ? j : j - half;
        float y = ldexpf(x[L::at(jj % 3, g, n, 3)], jj / 3);
        if (j >= half) y += kHalfPi;
        v = safe_sin(y);
      }
    }
    dst[p * ld + c] = from_f<T>(v);
  }
}

// cos of the argument that safe_sin reduces: the derivative of safe_sin.
__device__ inline float safe_cos(float y) {
  if (!(fabsf(y) < kTrigRange)) {
    float r = fmodf(y, kTrigRange);
    if (r != 0.f && r < 0.f) r += kTrigRange;
    y = r;
  }
  return cosf(y);
}

// Encoder policies: points(pts, covs, ...) and views(views, ...) encode
// the tile [base, base + M) of streams in layout L into shared memory.
struct NerfEnc {
  template <typename T, int M, typename L = ColMajor>
  __device__ static void points(const float* x, const float*, int n,
                                int base, int valid, const Dims& d, T* dst,
                                int ld) {
    encode<T, M, L>(x, n, base, valid, d.multires, d.P, dst, ld);
  }
  template <typename T, int M, typename L = ColMajor>
  __device__ static void views(const float* x, int n, int base, int valid,
                               const Dims& d, T* dst, int ld) {
    encode<T, M, L>(x, n, base, valid, d.multires_views, d.V, dst, ld);
  }
};

struct MipEnc {
  template <typename T, int M, typename L = ColMajor>
  __device__ static void points(const float* mean, const float* cov, int n,
                                int base, int valid, const Dims& d, T* dst,
                                int ld) {
    encode_ipe<T, M, L>(mean, cov, n, base, valid, d.multires, d.P, dst,
                        ld);
  }
  template <typename T, int M, typename L = ColMajor>
  __device__ static void views(const float* x, int n, int base, int valid,
                               const Dims& d, T* dst, int ld) {
    encode_mip_views<T, M, L>(x, n, base, valid, d.multires_views, d.V, dst,
                              ld);
  }
};

// Encode the tile [base, base + valid) of the streams into pe / ve. In
// the row-major layout the tile's points are first staged into `st`
// (9 M floats of free shared memory) and encoded from there; the
// transposed streams are read in place. The caller syncs before reading
// pe / ve.
template <typename T, int M, typename Enc, typename L>
__device__ void encode_tile(const float* pts, const float* covs,
                            const float* views, int n, int base, int valid,
                            const Dims& d, T* pe, int ldp, T* ve, int ldv,
                            float* st) {
  if constexpr (L::kRow) {
    stage_rows(pts, 3, base, valid, st);
    if (covs) stage_rows(covs, 3, base, valid, st + 3 * M);
    stage_rows(views, 3, base, valid, st + 6 * M);
    __syncthreads();
    Enc::template points<T, M, RowMajor>(st, st + 3 * M, M, 0, valid, d, pe,
                                         ldp);
    Enc::template views<T, M, RowMajor>(st + 6 * M, M, 0, valid, d, ve, ldv);
  } else {
    Enc::template points<T, M>(pts, covs, n, base, valid, d, pe, ldp);
    Enc::template views<T, M>(views, n, base, valid, d, ve, ldv);
  }
}

// ---------------------------------------------------------------------------
// Layer product
// ---------------------------------------------------------------------------

// dst[m, n] = act(sum over segments of seg[m, k] * Wt[k, n] + bias[n]).
template <int M>
__device__ void layer(Seg<bf16> s0, Seg<bf16> s1,
                      const bf16* __restrict__ wt, int n_out,
                      const float* __restrict__ bias, bool relu, bf16* dst,
                      int ldd, float* stage) {
  constexpr int RT = M / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ct = warp; ct < n_out / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
    const bf16* w = wt + ct * 16;
    for (int s = 0; s < 2; ++s) {
      const Seg<bf16> sg = s ? s1 : s0;
      for (int k0 = 0; k0 < sg.k; k0 += 16, w += 16 * n_out) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w, n_out);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sg.buf + r * 16 * sg.ld + k0, sg.ld);
          wmma::mma_sync(acc[r], a, b, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = e / 16, col = ct * 16 + e % 16;
        float v = stage[e] + bias[col];
        if (relu) v = fmaxf(v, 0.f);
        dst[(r * 16 + row) * ldd + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

template <int M>
__device__ void layer(Seg<float> s0, Seg<float> s1,
                      const float* __restrict__ wt, int n_out,
                      const float* __restrict__ bias, bool relu, float* dst,
                      int ldd, float*) {
  constexpr int RI = M / 16;
  constexpr int CJ = 8;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int c0 = 0; c0 < n_out; c0 += 16 * CJ) {
    float acc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
    const float* w = wt;
    for (int s = 0; s < 2; ++s) {
      const Seg<float> sg = s ? s1 : s0;
      for (int k = 0; k < sg.k; ++k, w += n_out) {
        float a[RI], b[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = sg.buf[(ty + 16 * i) * sg.ld + k];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = c0 + tx + 16 * j;
          b[j] = c < n_out ? w[c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < n_out) {
          float v = acc[i][j] + bias[c];
          if (relu) v = fmaxf(v, 0.f);
          dst[(ty + 16 * i) * ldd + c] = v;
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Vanilla compositing
// ---------------------------------------------------------------------------

// Alpha compositing of one ray of S samples, as the TPU kernels do it
// (consistentnerf_tpu/ops/fused_onepass.py::_composite_fwd): relu density,
// alpha = 1 - exp(-sigma * dist) with the last distance 1e10, both scaled
// by |d|; transmittance as the product of v = max(1 - alpha, 1e-10); white
// background; depth sum(w z). rw[k * ld + i] holds the raw heads (rgb
// logits k = 0..2, density 3) of sample i, z the ray's depths. Writes the
// rows [6, np] of `out` at the ray's points pt0..pt0 + S - 1 (rgb, depth
// and acc broadcast, then each sample's weight), the transmittance before
// each sample into tr (when not null), and returns rgb, depth and acc.
__device__ inline void composite_ray(const float* rw, int ld, const float* z,
                                     float dn, int S, bool white, float* tr,
                                     float* out, size_t np, size_t pt0,
                                     float rgb[3], float& dep, float& acc) {
  float T_ = 1.f;
  acc = 0.f;
  dep = 0.f;
  rgb[0] = rgb[1] = rgb[2] = 0.f;
  for (int i = 0; i < S; ++i) {
    const float dist = (i == S - 1 ? 1e10f : z[i + 1] - z[i]) * dn;
    const float sigma = rw[3 * ld + i];
    const float alpha = 1.f - expf(-fmaxf(sigma, 0.f) * dist);
    const float v = fmaxf(1.f - alpha, 1e-10f);
    if (tr) tr[i] = T_;
    const float w = alpha * T_;
    T_ *= v;
    acc += w;
    dep += w * z[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] += w / (1.f + expf(-rw[k * ld + i]));
    out[5 * np + pt0 + i] = w;
  }
  if (white)
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] += 1.f - acc;
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k * np + pt0 + i] = rgb[k];
    out[3 * np + pt0 + i] = dep;
    out[4 * np + pt0 + i] = acc;
  }
}

}  // namespace mlp
