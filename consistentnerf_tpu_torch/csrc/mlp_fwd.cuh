// The fused MLP forward walk: input encodings, trunk, heads, one kernel,
// for the NeRFMLP (fused_mlp_fwd.cu) and the MipMLP (fused_mip_fwd.cu)
// through an encoder policy (mlp_common.cuh).
//
// Bound: operations. One point costs ~1.2 MFLOP at 8x256 (1,186,816 FLOP
// for the NeRFMLP at multires 10+4, 1,220,608 for the MipMLP at 16+4)
// against 40 (NeRF: 6 floats in, 4 out) or 52 bytes (mip: 9 in, 4 out),
// ~23-30k FLOP per byte, far above the ~295 FLOP/byte ridge of an H100 in
// bf16. Design: a block owns a tile of M points and keeps every
// activation of that tile in shared memory (two ping-pong buffers of
// [M, W] plus the point and view encodings), so nothing but the input and
// the 4 output floats per point touches device memory. The weights
// (~1.2 MB in bf16) do not fit on-chip; each block streams every layer's
// weights straight from L2 into wmma fragments once per tile, so L2
// traffic per point is weights / M. The skip concat [pe, h] and the view
// concat [feature, ve] are never built: a layer's K loop runs over two
// shared-memory segments against the matching weight rows. Products use
// nvcuda::wmma bf16 16x16x16 fragments with fp32 accumulators; the
// epilogue adds the bias, applies ReLU and casts into the other buffer.
// The ragged last tile is zero-filled on load and masked on store. No
// cross-block reduction, so the output is deterministic.
//
// Rounding (as fused_mlp.py::_mlp_body and fused_mip.py::_mip_body):
// encodings in fp32 then cast; bf16 operands with fp32 accumulation; fp32
// biases; trunk layers ReLU then bf16; `feature` (the MipMLP's
// bottleneck) cast to bf16 without ReLU; the density and rgb heads stay
// fp32. With float weights the same walk runs in fp32 on the CUDA cores.
//
// Weight layout (ops/fused_mlp_v2.py::pack): one flat buffer of the
// element type, per layer W^T as [K_pad, N] row-major with K padded to a
// multiple of 16 by zero rows, in the order
//   pts_0 .. pts_{D-1}, feature, views_0, alpha [W], rgb [3, Hv];
// a post-skip layer's rows are [pe (P) | h (W)], views_0's rows are
// [feature (W) | ve (V)]. Biases: one flat fp32 buffer in the same order.

#pragma once

#include "mlp_common.cuh"

namespace mlp {

// The forward of one tile of M points [base, base + valid) of the streams
// (layout L: [3, n] or [n, 3]): the raw heads of point p go to
// out[L::at(c, off + p, ld, 4)] (c = rgb 0..2, density 3). `smem` is the
// block's dynamic shared memory (fwd_smem_bytes); the tile ends with a
// barrier, so a block may run tiles back to back.
template <typename T, int M, typename Enc, typename L = ColMajor>
__device__ void fwd_tile(const float* __restrict__ pts,
                         const float* __restrict__ covs,
                         const float* __restrict__ views,
                         const T* __restrict__ wflat,
                         const float* __restrict__ bflat, int n, int base,
                         int valid, const Dims& d, unsigned char* smem,
                         float* out, size_t ld, size_t off) {
  const int P = d.P, V = d.V, width = d.width;
  const int ldp = P + kPad, ldv = V + kPad, ldh = d.act_cols() + kPad;
  T* pe = reinterpret_cast<T*>(smem);
  T* ve = pe + M * ldp;
  T* hx = ve + M * ldv;
  T* hy = hx + M * ldh;
  float* stage = reinterpret_cast<float*>(hy + M * ldh) +
                 (threadIdx.x / 32) * 256;

  // The row-major tile is staged in the (still free) epilogue stage.
  encode_tile<T, M, Enc, L>(pts, covs, views, n, base, valid, d, pe, ldp,
                            ve, ldv, reinterpret_cast<float*>(hy + M * ldh));
  __syncthreads();

  const T* w = wflat;
  const float* b = bflat;
  T* h = nullptr;
  for (int i = 0; i < d.depth; ++i) {
    Seg<T> s0, s1 = {nullptr, 0, 0};
    if (i == 0) {
      s0 = {pe, ldp, P};
    } else if (d.skip_before(i)) {
      s0 = {pe, ldp, P};
      s1 = {h, ldh, width};
    } else {
      s0 = {h, ldh, width};
    }
    T* dst = (h == hx) ? hy : hx;
    layer<M>(s0, s1, w, width, b, true, dst, ldh, stage);
    __syncthreads();
    h = dst;
    w += (size_t)d.rows(i) * width;
    b += width;
  }

  const int half = d.half;
  const T* wf = w;
  const T* wv = wf + (size_t)width * width;
  const T* wa = wv + (size_t)(width + V) * half;
  const T* wr = wa + width;
  const float* bfe = b;
  const float* bv = bfe + width;
  const float* ba = bv + half;
  const float* br = ba + 1;

  // alpha head (fp32 out) reads h before the view layer overwrites it.
  for (int p = threadIdx.x; p < valid; p += kThreads) {
    float s = 0.f;
    for (int c = 0; c < width; ++c)
      s = fmaf(to_f(h[p * ldh + c]), to_f(wa[c]), s);
    out[L::at(3, off + p, ld, 4)] = s + ba[0];
  }
  T* feat = (h == hx) ? hy : hx;
  layer<M>(Seg<T>{h, ldh, width}, Seg<T>{nullptr, 0, 0}, wf, width, bfe,
           false, feat, ldh, stage);
  __syncthreads();
  layer<M>(Seg<T>{feat, ldh, width}, Seg<T>{ve, ldv, V}, wv, half, bv, true,
           h, ldh, stage);
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * M; e += kThreads) {
    const int p = e % M, c = e / M;
    if (p < valid) {
      float s = 0.f;
      for (int k = 0; k < half; ++k)
        s = fmaf(to_f(h[p * ldh + k]), to_f(wr[c * half + k]), s);
      out[L::at(c, off + p, ld, 4)] = s + br[c];
    }
  }
  __syncthreads();
}

template <typename T, int M, typename Enc, typename L>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const float* __restrict__ pts, const float* __restrict__ covs,
               const float* __restrict__ views, const T* __restrict__ wflat,
               const float* __restrict__ bflat, float* __restrict__ out,
               int n, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int base = blockIdx.x * M;
  fwd_tile<T, M, Enc, L>(pts, covs, views, wflat, bflat, n, base,
                         min(M, n - base), d, smem, out, (size_t)n,
                         (size_t)base);
}

// Dynamic shared memory of one forward block, in bytes.
template <typename T, int M>
__host__ __device__ size_t fwd_smem_bytes(const Dims& d) {
  const size_t elems = (size_t)M * (d.P + kPad) + (size_t)M * (d.V + kPad) +
                       2 * (size_t)M * (d.act_cols() + kPad);
  return elems * sizeof(T) + kWarps * 256 * sizeof(float);
}

template <typename T, int M, typename Enc, typename L = ColMajor>
int fwd_launch(const void* pts, const void* covs, const void* views,
               const void* w, const void* b, void* out, int n, Dims d,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, M>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, M, Enc, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + M - 1) / M;
  fwd_kernel<T, M, Enc, L><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(covs),
      static_cast<const float*>(views), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), n, d);
  return (int)cudaGetLastError();
}

}  // namespace mlp
