// The bf16 walk of the one-pass level kernels #3 (onepass_level.cu, mode
// 3) and #5 (onepass_mip_level.cu, mode 4), and their dW product, for
// Hopper. The fp32 path of both kernels and the other train kernels
// (modes 2 and 5) keep mlp_train.cuh::train_block.
//
// What it replaces: train_block in modes 3 and 4 ran forward, compositing,
// backward AND the dW pass per 768-point chunk in one persistent block.
// Its dW pass loaded every fp32 dW block from the block's partial in
// device memory, accumulated 768 points with legacy wmma over slabs
// copied synchronously, and stored it back (2 x 2.4 MB of partial traffic
// per chunk; 132 partials of ~4.8 MB do not fit the 50 MB L2): half of
// the level's time (52 of 100 ms at the flagship step's fine level on an
// H100). Its walks loaded every weight fragment from L2 in each warp and
// waited on it (the backward walk a third of the time).
//
// The level now takes three launches:
//   1. level_walk: per chunk of whole rays, the forward (saving every
//      activation), compositing, the per-ray loss cotangent, the
//      compositing VJP and the backward (saving every rounded gradient),
//      the bias grads and the heads' dW (alpha [W], rgb [3, H]), which
//      ride on the backward's elementwise steps at no extra read. Every
//      layer product runs on wgmma (m64n64k16, A = the 64-point tile
//      from shared memory through ldmatrix, B = the weights) fed by a
//      weight stream: the order of the products is fixed, so thread 0
//      keeps three 32 KB slabs of weights in flight by TMA in a ring
//      under mbarriers while the two warpgroups multiply. The epilogues
//      work on the accumulators in registers: bias and ReLU into the next
//      bf16 tile, or (backward) the mask, the rounding and the bias column
//      sums (warp shuffles, then a fixed order over the warps). The
//      workspace is the whole level's, one bf16 row per point (Cols),
//      written with 16-byte stores. Widths over 256 (or a shared memory
//      too small for the ring) run the legacy walk of the other train
//      kernels (mlp_train.cuh::train_block, its dW pass inside) instead.
//   2. dw_gemm: every dW matrix of the MLP as one split-K GEMM over the
//      level's points, dW = A^T G with A the saved layer input [R, K] and
//      G the saved pre-activation gradient [R, N]. A work unit is a
//      128 x 256 output tile and one of `splits` contiguous ranges of
//      points; its accumulator stays in registers over the whole range
//      (~30,000 points at the fine level, where the old pass re-read it
//      every 768). One thread issues TMA loads of 64-point slabs of A
//      (two 64-feature boxes) and G (up to four 64-column boxes) into a
//      4-stage ring under mbarriers, 128-byte swizzled; two consumer
//      warpgroups (64 features each) run wgmma with both operands
//      MN-major from shared memory, so the copies of the next three
//      slabs overlap the products on the current one and each slab of A
//      is read once per tile. Consecutive blocks take the tiles of one
//      range, so their slabs meet in L2.
//   3. level_reduce: sums the split partials in split order and the
//      walk's per-block partials (heads and biases) in block order. No
//      atomics: two runs give the same bits.
//
// Bound on this card: operations, as in mlp_train.cuh (3x the forward's
// FLOP a point). What it costs instead: bytes of L2 and HBM. The walk's
// products read 1.2 MB of weights each way per 64-point tile from L2
// (every SM the same slab at about the same time); the workspace (~9.9
// KB a point at 8x256, written once by the walk, read once or twice by
// the GEMM) is ~7 ms of HBM traffic at the fine level's 786,432 points,
// and takes that many rows of device memory (7.8 GB at the fine level).
//
// Chunks: whole rays, at most 768 points, and as many rays a chunk as
// keep the last wave of the walk's persistent grid full (level_plan): the
// fine level 4 rays of 192 (8 waves), the coarse level 8 rays of 64 (4
// waves, where 12 rays made 2.6), a mip level 8 rays of 96.
//
// Rounding is train_block's (mlp_train.cuh, _aligned_backward_from_res):
// the same bf16 roundings at the same points (the wgmma products give the
// wmma products' bits). Only fp32 sums run in another order: the bias
// column sums of the backward's products, the heads' dW (per 64-point
// sub-tile, then per chunk) and the dW (the GEMM's order).

#pragma once

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "mlp_train.cuh"

namespace mlp {

// Column offsets of one point's row in the level workspace.
struct Cols {
  int pe, ve, act, feat, hv, gpre, gfeat, ghv, total;
  __host__ __device__ explicit Cols(const Dims& d) {
    int o = 0;
    pe = o; o += d.P;
    ve = o; o += d.V;
    act = o; o += d.depth * d.width;
    feat = o; o += d.width;
    hv = o; o += d.half;
    gpre = o; o += d.depth * d.width;
    gfeat = o; o += d.width;
    ghv = o; o += d.half;
    total = o;
  }
};

// A float rounded to bf16 and back.
__device__ inline float rnd(float v) { return to_f(from_f<bf16>(v)); }

// ---------------------------------------------------------------------------
// The walk's layer products on wgmma, fed by a stream of weight slabs
// ---------------------------------------------------------------------------
//
// Every product of the walk multiplies a 64-point bf16 tile in shared
// memory (padded row-major, read into registers with ldmatrix as wgmma's
// A) by a layer's packed weights W^T [K, N] (wgmma's B, from shared
// memory). The weights do not depend on the data, so the order in which
// the walk needs them is known in advance: per chunk, for each 64-point
// sub-tile the forward's products (the trunk layers, feature, views),
// then for each sub-tile the backward's (views^T, feature^T, the trunk
// layers from the top down to layer 1). Thread 0 walks that order and
// keeps kWStages slabs of it in flight in a ring of shared memory, by TMA
// under mbarriers (a full barrier a slot, and an empty one that both
// warpgroups arrive on when their MMAs on the slab are done); the walk
// consumes them in the same order. A slab is up to four 64 x 64 boxes,
// 128-byte swizzled: forward, 64 rows of K by up to 256 columns of N
// (MN-major B, tnspB = 1); backward, 64 columns of N (the reduction) by up
// to 256 rows of K (K-major B, tnspB = 0). The two warpgroups split the
// product's outputs: each takes up to two 64-wide blocks (m64n64k16, 64
// fp32 accumulators a thread), and the epilogue works on the
// accumulators in registers: bias and ReLU into the next bf16 tile
// (forward), or mask, rounding and bias column sums (backward). Where the
// old products loaded every weight fragment from L2 in each warp and
// waited on it, the copies of the next slabs overlap the MMAs here.

constexpr int kWStages = 3;
constexpr int kWBox = 8192;             // one weight box: 64 x 64 bf16
constexpr int kWStage = 4 * kWBox;      // up to four boxes a slab

// One product of the stream: direction (0 forward, 1 backward), map (0 T,
// 1 V), its first row in the map, reduction length, outputs.
constexpr int kMaxProbs = 32;  // dW problems (and a bound on products)

struct WProd {
  int dir, map, row0, red, out;
};

// Products a sub-tile: forward (the trunk layers, feature, views) and
// backward (views^T, feature^T, the trunk layers from the top to 1).
__host__ __device__ inline int wprods_fwd(const Dims& d) {
  return d.depth + 2;
}
__host__ __device__ inline int wprods_bwd(const Dims& d) {
  return d.depth + 1;
}

// Product q of a chunk's sequence (nsub sub-tiles).
__host__ __device__ inline WProd wprod(const Dims& d, int q, int nsub) {
  const int nf = wprods_fwd(d), nb = wprods_bwd(d), W = d.width;
  if (q < nsub * nf) {
    const int f = q % nf;
    if (f < d.depth)
      return WProd{0, 0, (int)(d.w_layer(f) / W), d.rows(f), W};
    if (f == d.depth) return WProd{0, 0, (int)(d.w_feature() / W), W, W};
    return WProd{0, 1, 0, W + d.V, d.half};
  }
  const int b = (q - nsub * nf) % nb;
  if (b == 0) return WProd{1, 1, 0, d.half, W};
  if (b == 1) return WProd{1, 0, (int)(d.w_feature() / W), W, W};
  const int i = d.depth + 1 - b;
  return WProd{1, 0,
               (int)(d.w_layer(i) / W) + (d.skip_before(i) ? d.P : 0), W, W};
}

__host__ __device__ inline int wslabs(const WProd& p) {
  return (p.red + 63) / 64;
}

// Slabs of one chunk's sequence.
__host__ __device__ inline int wslabs_chunk(const Dims& d, int nsub) {
  int n = 0;
  for (int q = 0; q < nsub * (wprods_fwd(d) + wprods_bwd(d)); ++q)
    n += wslabs(wprod(d, q, nsub));
  return n;
}

struct WStream {
  unsigned char* ring;  // kWStages slabs, 1024-byte aligned
  uint64_t* full;       // per slot: the slab has landed (TMA bytes)
  uint64_t* empty;      // per slot: both warpgroups are done with it
  const WProd* tab;     // the forward's products, then the backward's
  int nsub;             // sub-tiles a chunk
  int t;                // slabs consumed
  int issued, q, j;     // thread 0: slabs issued, cursor (product, slab)
  int left;             // thread 0: slabs still to issue
};

// Thread 0: the slab at the cursor into its slot, once both warpgroups
// have released the slab that held the slot before.
__device__ inline void wissue(WStream& st, const WMaps& maps,
                              const Dims& d) {
  const int nf = wprods_fwd(d), nb = wprods_bwd(d), qf = st.nsub * nf;
  const WProd p = st.tab[st.q < qf ? st.q % nf : nf + (st.q - qf) % nb];
  const int slot = st.issued % kWStages;
  if (st.issued >= kWStages)
    mbar_wait(&st.empty[slot], (st.issued / kWStages - 1) & 1);
  unsigned char* dst = st.ring + slot * kWStage;
  const int nbx = (p.out + 63) / 64;
  mbar_expect_tx(&st.full[slot], (uint32_t)nbx * kWBox);
  for (int b = 0; b < nbx; ++b) {
    if (p.dir == 0)
      tma_load_2d(dst + b * kWBox, &maps.m[p.map], &st.full[slot], 64 * b,
                  p.row0 + 64 * st.j);
    else
      tma_load_2d(dst + b * kWBox, &maps.m[p.map], &st.full[slot], 64 * st.j,
                  p.row0 + 64 * b);
  }
  ++st.issued;
  --st.left;
  if (++st.j == wslabs(p)) {
    st.j = 0;
    if (++st.q == st.nsub * (nf + nb)) st.q = 0;
  }
}

// Slab u is done in this warpgroup: one arrival on its slot's empty
// barrier; thread 0 then refills the ring.
__device__ inline void wrelease(WStream& st, const WMaps& maps,
                                const Dims& d, int u) {
  if (threadIdx.x % 128 == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(&st.empty[u % kWStages]))
                 : "memory");
  if (threadIdx.x == 0 && st.left > 0) wissue(st, maps, d);
}

// The next product of the stream on the 64-point tile [s0 | s1] (its
// reduction): acc[bb] is output block (warpgroup) * NBH + bb of 64. The
// MMAs of one slab run while the next slab's A fragments load; a slab is
// released once its MMAs are done (wgmma.wait_group 1).
template <bool FWD, int NBH>
__device__ inline void wg_product(WStream& st, const WMaps& maps,
                                  const Dims& d, Seg<bf16> s0, Seg<bf16> s1,
                                  float (&acc)[2][32]) {
  const int tid = threadIdx.x, wg = tid / 128, w = (tid % 128) / 32;
  const int lane = tid % 32;
  const int red = s0.k + s1.k, n_slabs = (red + 63) / 64;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[bb][r] = 0.f;
  for (int j = 0; j < n_slabs; ++j) {
    const int u = st.t + j, slot = u % kWStages;
    // A fragments past the reduction are zero (the slab's rows there are
    // another layer's weights, or TMA's zero fill), so every slab issues
    // the same MMAs and no branch sits between them.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 64 * j + 16 * kk;
      const bool ok = k < red;
      const Seg<bf16> sg = ok && k >= s0.k ? s1 : s0;
      const int kc = (ok ? (k < s0.k ? k : k - s0.k) : 0) + (lane / 16) * 8;
      ldsm_x4(a[kk], sg.buf + (16 * w + lane % 16) * sg.ld + kc);
#pragma unroll
      for (int q = 0; q < 4; ++q) a[kk][q] = ok ? a[kk][q] : 0u;
    }
    mbar_wait(&st.full[slot], (u / kWStages) & 1);
    const uint32_t sb = smem_u32(st.ring + slot * kWStage);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int bb = 0; bb < NBH; ++bb) {
        // Blocks past nbx (an odd count) compute on a box that was not
        // loaded; their columns are never stored.
        const int b = wg * NBH + bb;
        // A 16-deep step: 16 rows of 128 bytes (MN-major), or 32 bytes
        // along each 128-byte row (K-major).
        if (FWD)
          wgmma_rs<1>(acc[bb], a[kk], sw128_desc(sb + b * kWBox + kk * 2048));
        else
          wgmma_rs<0>(acc[bb], a[kk], sw128_desc(sb + b * kWBox + kk * 32));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (j > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      wrelease(st, maps, d, u - 1);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  wrelease(st, maps, d, st.t + n_slabs - 1);
  st.t += n_slabs;
}

// Accumulator fragment of m64n64: register r of thread (warp w of its
// warpgroup, lane l) holds row 16 w + l / 4 (+ 8 for r % 4 >= 2), column
// 8 (r / 4) + 2 (l % 4) (+ 1 for odd r).

// Forward: dst[m, n] = act(sum_k [s0 | s1][m, k] Wt[k, n] + bias[n]).
__device__ inline void wg_layer(WStream& st, const WMaps& maps,
                                const Dims& d, Seg<bf16> s0, Seg<bf16> s1,
                                int n_out, const float* __restrict__ bias,
                                bool relu, bf16* dst, int ldd) {
  const int nbx = (n_out + 63) / 64, nbh = (nbx + 1) / 2;
  float acc[2][32];
  if (nbh == 2)
    wg_product<true, 2>(st, maps, d, s0, s1, acc);
  else
    wg_product<true, 1>(st, maps, d, s0, s1, acc);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row = 16 * ((tid % 128) / 32) + lane / 4;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    const int b = wg * nbh + bb;
    if (bb >= nbh || b >= nbx) continue;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = 64 * b + 8 * n8 + 2 * (lane % 4);
      if (col >= n_out) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[bb][4 * n8 + 2 * h] + bias[col];
        float v1 = acc[bb][4 * n8 + 2 * h + 1] + bias[col + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8 * h) * ldd + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Sum over the 8 lanes of a warp that share lane % 4: a column's 16 rows
// of the warp.
__device__ inline float rows16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Column c's sum from the per-warp partials csum [kWarps][ldc]: the four
// warps of the warpgroup that owns its block, in warp order.
__device__ inline float wg_colsum(const float* csum, int ldc, int c,
                                  int nbh) {
  const float* p = csum + 4 * ((c / 64) / nbh) * ldc + c;
  return ((p[0] + p[ldc]) + p[2 * ldc]) + p[3 * ldc];
}

// Backward: the next product of the stream, o[m, k] = sum_{n < n_red}
// g[m, n] Wt[k, n] for k < k_out, fused with the elementwise step it
// feeds: v = o (+ round(g_alpha[m]) wa[k] at TOP), zero where act[m, k]
// <= 0 (MASK; act: the workspace rows of the layer's activations, row
// stride ldw), rounded to bf16 into dst. Per-warp column sums of v go to
// csum and, at TOP, of act round(g_alpha) (the alpha head's dW) to csum2.
// The activations are read from the workspace after the product, one
// output block at a time (loading them before it, to hide their latency,
// cost more in register spills than it saved).
template <int NBH, bool MASK, bool TOP>
__device__ inline void wg_bwd(WStream& st, const WMaps& maps, const Dims& d,
                              const bf16* g, int ldg, int n_red, int k_out,
                              const bf16* act, int ldw, const float* ga_raw,
                              const bf16* __restrict__ wa, bf16* dst, int ldd,
                              float* csum, float* csum2, int ldc) {
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row = 16 * ((tid % 128) / 32) + lane / 4;
  const int nbx = (k_out + 63) / 64;
  float acc[2][32];
  wg_product<false, NBH>(st, maps, d, Seg<bf16>{g, ldg, n_red},
                         Seg<bf16>{nullptr, 0, 0}, acc);
  const float ga[2] = {TOP ? rnd(ga_raw[row]) : 0.f,
                       TOP ? rnd(ga_raw[row + 8]) : 0.f};
#pragma unroll
  for (int bb = 0; bb < NBH; ++bb) {
    const int b = wg * NBH + bb;
    uint32_t av[8][2];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = 64 * b + 8 * n8 + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[n8][h] = MASK && col < k_out
                        ? *reinterpret_cast<const uint32_t*>(
                              act + (size_t)(row + 8 * h) * ldw + col)
                        : 0u;
    }
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = 64 * b + 8 * n8 + 2 * (lane % 4);
      const bool in = b < nbx && col < k_out;
      float cs0 = 0.f, cs1 = 0.f, ca0 = 0.f, ca1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[bb][4 * n8 + 2 * h], v1 = acc[bb][4 * n8 + 2 * h + 1];
        if (TOP && in) {
          v0 = fmaf(ga[h], to_f(wa[col]), v0);
          v1 = fmaf(ga[h], to_f(wa[col + 1]), v1);
        }
        const uint32_t a2 = av[n8][h];
        const float a0 = __uint_as_float(a2 << 16),
                    a1 = __uint_as_float(a2 & 0xffff0000u);
        if (MASK) {
          if (!(a0 > 0.f)) v0 = 0.f;
          if (!(a1 > 0.f)) v1 = 0.f;
        }
        if (in) {
          cs0 += v0;
          cs1 += v1;
          if (TOP) {
            ca0 = fmaf(a0, ga[h], ca0);
            ca1 = fmaf(a1, ga[h], ca1);
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8 * h) * ldd +
                                             col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      cs0 = rows16(cs0);
      cs1 = rows16(cs1);
      if (TOP) {
        ca0 = rows16(ca0);
        ca1 = rows16(ca1);
      }
      if (lane < 4 && in) {
        float* c = csum + (tid / 32) * ldc + col;
        c[0] = cs0;
        c[1] = cs1;
        if (TOP) {
          c = csum2 + (tid / 32) * ldc + col;
          c[0] = ca0;
          c[1] = ca1;
        }
      }
    }
  }
}

// Shared memory of one walk block, in bytes (must match the carve-up in
// level_walk): the weight ring (and its alignment slack), the tiles, the
// per-chunk rows and the column-sum partials.
__host__ __device__ inline size_t level_smem(const Dims& d, int rows) {
  constexpr int M = 64;
  const int ac = d.act_cols();
  const size_t elems = (size_t)M * (d.P + kPad) + (size_t)M * (d.V + kPad) +
                       2 * (size_t)M * (ac + kPad);
  const size_t floats =
      4 * M + 5 * (size_t)rows + 2 * (size_t)kWarps * ac;
  return (size_t)kWStages * kWStage + 1024 + elems * sizeof(bf16) +
         floats * sizeof(float);
}

// Rows [row0, row0 + M) of an [M, cols] shared tile (ld) into the
// workspace columns [col0, col0 + cols), 16 bytes a thread.
template <int M>
__device__ inline void save_rows(const bf16* src, int ld, int cols,
                                 bf16* ws, int ldw, size_t row0, int col0) {
  const int v = cols / 8;
  for (int e = threadIdx.x; e < M * v; e += kThreads) {
    const int p = e / v, c = (e % v) * 8;
    *reinterpret_cast<uint4*>(ws + (row0 + p) * ldw + col0 + c) =
        *reinterpret_cast<const uint4*>(src + p * ld + c);
  }
}

// Element q (a constant after unrolling) of 8 bf16 packed in a uint4.
__device__ inline float lane8(const uint4& v, int q) {
  const uint32_t w = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Eight floats rounded to bf16 (round to nearest even), packed.
__device__ inline uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One block's walk over its chunks of `cpts` points (whole rays). The
// partial of the block holds the packed grad from w_alpha() on: the alpha
// head's dW [W], the rgb head's [3, H], then every bias.
template <int MODE, typename Enc>
__device__ void level_walk(const float* __restrict__ pts,
                           const float* __restrict__ covs,
                           const float* __restrict__ views, RayRows rr,
                           const bf16* __restrict__ wflat,
                           const float* __restrict__ bflat,
                           bf16* __restrict__ ws, float* part_all,
                           size_t part_stride, int cpts, Dims d,
                           const WMaps& maps) {
  static_assert(MODE == 3 || MODE == 4, "one-pass levels only");
  using T = bf16;
  constexpr int M = 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t wfull[kWStages], wempty[kWStages];
  __shared__ WProd wtab[2 * kMaxProbs];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int W = d.width, H = d.half, P = d.P, V = d.V;
  const int n = rr.n_rays * rr.seg;
  const int rows = pad64(cpts);
  const Cols cl(d);
  const int ldw = cl.total;
  const int ldp = P + kPad, ldv = V + kPad, ldh = d.act_cols() + kPad;
  const int ldc = d.act_cols();
  T* pe = reinterpret_cast<T*>(ring + kWStages * kWStage);
  T* ve = pe + M * ldp;
  T* hx = ve + M * ldv;
  T* hy = hx + M * ldh;
  float* graw = reinterpret_cast<float*>(hy + M * ldh);  // [4][M]
  float* craw = graw + 4 * M;   // [4][rows] raw, then d_raw
  float* ctrans = craw + 4 * rows;  // [rows]
  float* csum = ctrans + rows;  // [2][kWarps][ldc] column-sum partials

  float* ph = part_all + blockIdx.x * part_stride;  // heads' dW
  float* pb = ph + W + 3 * H;                       // biases
  for (size_t j = threadIdx.x; j < part_stride; j += kThreads) ph[j] = 0.f;

  const T* w_a = wflat + d.w_alpha();
  const T* w_r = wflat + d.w_rgb();
  const int n_chunks = (n + cpts - 1) / cpts;

  WStream st{ring, wfull, wempty, wtab, rows / M, 0, 0, 0, 0, 0};
  if (threadIdx.x == 0) {
    const int mine = blockIdx.x < n_chunks
                         ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1
                         : 0;
    st.left = mine * wslabs_chunk(d, st.nsub);
    const int nf = wprods_fwd(d), nb = wprods_bwd(d);
    for (int k = 0; k < nf + nb; ++k)
      wtab[k] = wprod(d, k < nf ? k : st.nsub * nf + k - nf, st.nsub);
    for (int k = 0; k < kWStages; ++k) {
      mbar_init(&wfull[k], 1);
      mbar_init(&wempty[k], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kWStages && st.left > 0; ++k) wissue(st, maps, d);
  }
  __syncthreads();

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int base = c * cpts;
    const int valid = min(cpts, n - base);
    const size_t crow = (size_t)c * rows;
    // ---- forward over sub-tiles, saving every activation ----
    for (int r0 = 0; r0 < rows; r0 += M) {
      const int sub_valid = max(0, min(M, valid - r0));
      const size_t prow = crow + r0;
      encode_tile<T, M, Enc, ColMajor>(pts, covs, views, n, base + r0,
                                       sub_valid, d, pe, ldp, ve, ldv,
                                       nullptr);
      __syncthreads();
      save_rows<M>(pe, ldp, P, ws, ldw, prow, cl.pe);
      save_rows<M>(ve, ldv, V, ws, ldw, prow, cl.ve);
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
        wg_layer(st, maps, d, s0, s1, W, b, true, dst, ldh);
        __syncthreads();
        save_rows<M>(dst, ldh, W, ws, ldw, prow, cl.act + i * W);
        h = dst;
        b += W;
      }
      for (int p = threadIdx.x; p < M; p += kThreads) {  // alpha head, fp32
        float s = 0.f;
        for (int k = 0; k < W; ++k)
          s = fmaf(to_f(h[p * ldh + k]), to_f(w_a[k]), s);
        craw[3 * rows + r0 + p] = s + bflat[d.b_alpha()];
      }
      T* feat = (h == hx) ? hy : hx;
      wg_layer(st, maps, d, Seg<T>{h, ldh, W}, Seg<T>{nullptr, 0, 0}, W,
               bflat + d.b_feature(), false, feat, ldh);
      __syncthreads();
      save_rows<M>(feat, ldh, W, ws, ldw, prow, cl.feat);
      wg_layer(st, maps, d, Seg<T>{feat, ldh, W}, Seg<T>{ve, ldv, V}, H,
               bflat + d.b_views(), true, h, ldh);
      __syncthreads();
      save_rows<M>(h, ldh, H, ws, ldw, prow, cl.hv);
      for (int e = threadIdx.x; e < 3 * M; e += kThreads) {
        const int p = e % M, cc = e / M;
        float s = 0.f;
        for (int k = 0; k < H; ++k)
          s = fmaf(to_f(h[p * ldh + k]), to_f(w_r[cc * H + k]), s);
        craw[cc * rows + r0 + p] = s + bflat[d.b_rgb() + cc];
      }
      __syncthreads();
    }

    // ---- compositing and the per-ray loss cotangent ----
    if (MODE == 3) vanilla_composite(rr, c, cpts, rows, craw, ctrans);
    if (MODE == 4) mip_composite(rr, c, cpts, rows, craw, ctrans);

    // ---- backward over sub-tiles ----
    for (int r0 = 0; r0 < rows; r0 += M) {
      const size_t prow = crow + r0;
      for (int e = threadIdx.x; e < 4 * M; e += kThreads)
        graw[e] = craw[(e / M) * rows + r0 + e % M];
      __syncthreads();
      if (threadIdx.x < 4) {  // rgb and alpha bias grads (fp32 sums)
        const int k = threadIdx.x;
        float s = 0.f;
        for (int p = 0; p < M; ++p) s += graw[k * M + p];
        pb[k < 3 ? d.b_rgb() + k : d.b_alpha()] += s;
      }
      // g_hv = (round(g_rgb) @ Wr) * (hv > 0), 8 columns a thread; hv is
      // kept in hy for the rgb head's dW.
      const int h8 = H / 8;
      for (int e = threadIdx.x; e < M * h8; e += kThreads) {
        const int p = e / h8, j0 = (e % h8) * 8;
        const uint4 hv8 = *reinterpret_cast<const uint4*>(
            ws + (prow + p) * ldw + cl.hv + j0);
        *reinterpret_cast<uint4*>(hy + p * ldh + j0) = hv8;
        const float g0 = rnd(graw[p]), g1 = rnd(graw[M + p]),
                    g2 = rnd(graw[2 * M + p]);
        float o8[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + q;
          float v = fmaf(g0, to_f(w_r[j]), 0.f);
          v = fmaf(g1, to_f(w_r[H + j]), v);
          v = fmaf(g2, to_f(w_r[2 * H + j]), v);
          if (!(lane8(hv8, q) > 0.f)) v = 0.f;
          o8[q] = v;
        }
        const uint4 ov = pack8(o8);
        *reinterpret_cast<uint4*>(hx + p * ldh + j0) = ov;
        *reinterpret_cast<uint4*>(ws + (prow + p) * ldw + cl.ghv + j0) = ov;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < H; j += kThreads) {
        // The bias sum of g_hv (recomputed as above) and the rgb head's
        // dW, hv^T round(g_rgb).
        const float w0 = to_f(w_r[j]), w1 = to_f(w_r[H + j]),
                    w2 = to_f(w_r[2 * H + j]);
        float colsum = 0.f, s[3] = {0.f, 0.f, 0.f};
        for (int p = 0; p < M; ++p) {
          const float hv = to_f(hy[p * ldh + j]);
          const float g0 = rnd(graw[p]), g1 = rnd(graw[M + p]),
                      g2 = rnd(graw[2 * M + p]);
          float v = fmaf(g2, w2, fmaf(g1, w1, fmaf(g0, w0, 0.f)));
          if (!(hv > 0.f)) v = 0.f;
          colsum += v;
          s[0] = fmaf(hv, g0, s[0]);
          s[1] = fmaf(hv, g1, s[1]);
          s[2] = fmaf(hv, g2, s[2]);
        }
        pb[d.b_views() + j] += colsum;
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) ph[W + cc * H + j] += s[cc];
      }
      __syncthreads();
      // The products fused with the elementwise steps they feed (see
      // wg_bwd): g_feat = round(g_hv) Wv[feature rows]^T, rounded into
      // hy; g_h = round(g_feat) Wf^T + round(g_alpha) wa, masked by the
      // top layer's activations and rounded into hx; then down the
      // trunk. Each step's rounded tile goes to the workspace.
      const int nbh = (W + 63) / 64 > 2 ? 2 : 1;
      auto step = [&](auto mask, auto top, const T* g, int n_red,
                      const T* act, T* dst, int bias_off, int ws_col) {
        constexpr bool kMask = decltype(mask)::value;
        constexpr bool kTop = decltype(top)::value;
        if (nbh == 2)
          wg_bwd<2, kMask, kTop>(st, maps, d, g, ldh, n_red, W, act, ldw,
                                 graw + 3 * M, w_a, dst, ldh, csum,
                                 csum + kWarps * ldc, ldc);
        else
          wg_bwd<1, kMask, kTop>(st, maps, d, g, ldh, n_red, W, act, ldw,
                                 graw + 3 * M, w_a, dst, ldh, csum,
                                 csum + kWarps * ldc, ldc);
        __syncthreads();
        for (int j = threadIdx.x; j < W; j += kThreads) {
          pb[bias_off + j] += wg_colsum(csum, ldc, j, nbh);
          if (kTop) ph[j] += wg_colsum(csum + kWarps * ldc, ldc, j, nbh);
        }
        save_rows<M>(dst, ldh, W, ws, ldw, prow, ws_col);
        __syncthreads();
      };
      using F = std::false_type;
      using Tr = std::true_type;
      step(F{}, F{}, hx, H, nullptr, hy, d.b_feature(), cl.gfeat);
      const T* act_top = ws + prow * ldw + cl.act + (d.depth - 1) * W;
      step(Tr{}, Tr{}, hy, W, act_top, hx, d.b_layer(d.depth - 1),
           cl.gpre + (d.depth - 1) * W);
      T* cur = hx;
      for (int i = d.depth - 1; i > 0; --i) {
        T* other = (cur == hx) ? hy : hx;
        step(Tr{}, F{}, cur, W, ws + prow * ldw + cl.act + (i - 1) * W,
             other, d.b_layer(i - 1), cl.gpre + (i - 1) * W);
        cur = other;
      }
    }
    // ---- end of the backward ----
  }
}

// ---------------------------------------------------------------------------
// dW = A^T G over the level's points (TMA + wgmma)
// ---------------------------------------------------------------------------

// One dW matrix: A = workspace columns [a_col, a_col + K), G = columns
// [g_col, g_col + N), written row-major [K, N] at packed offset dst.
struct GemmProb {
  int a_col, K, g_col, N;
  long long dst;
};

__host__ __device__ inline int gemm_probs(const Dims& d, GemmProb* p) {
  const Cols cl(d);
  const int W = d.width, P = d.P;
  int k = 0;
  p[k++] = GemmProb{cl.pe, P, cl.gpre, W, (long long)d.w_layer(0)};
  for (int i = 1; i < d.depth; ++i) {
    const long long o = (long long)d.w_layer(i);
    const int g = cl.gpre + i * W, a = cl.act + (i - 1) * W;
    if (d.skip_before(i)) {
      p[k++] = GemmProb{cl.pe, P, g, W, o};
      p[k++] = GemmProb{a, W, g, W, o + (long long)P * W};
    } else {
      p[k++] = GemmProb{a, W, g, W, o};
    }
  }
  p[k++] = GemmProb{cl.act + (d.depth - 1) * W, W, cl.gfeat, W,
                    (long long)d.w_feature()};
  p[k++] = GemmProb{cl.feat, W, cl.ghv, d.half, (long long)d.w_views()};
  p[k++] = GemmProb{cl.ve, d.V, cl.ghv, d.half,
                    (long long)d.w_views() + (long long)W * d.half};
  return k;
}

// An output tile: features [a_col, a_col + kv) (kv <= 128) by all the
// problem's nv columns (nv <= kTileN: the plan takes the level walk only
// for widths up to 256), at packed offset dst with row stride ldd.
struct GemmTile {
  int a_col, kv, g_col, nv, ldd;
  long long dst;
};
constexpr int kTileK = 128, kTileN = 256;

// The number of tiles; with `out`, tile t of them.
__host__ __device__ inline int gemm_tiles(const Dims& d, int t,
                                          GemmTile* out) {
  GemmProb p[kMaxProbs];
  const int np = gemm_probs(d, p);
  int count = 0;
  for (int q = 0; q < np; ++q) {
    const int mt = (p[q].K + kTileK - 1) / kTileK;
    if (out && t >= count && t < count + mt) {
      const int mi = t - count;
      out->a_col = p[q].a_col + kTileK * mi;
      out->kv = min(kTileK, p[q].K - kTileK * mi);
      out->g_col = p[q].g_col;
      out->nv = p[q].N;
      out->ldd = p[q].N;
      out->dst = p[q].dst + (long long)kTileK * mi * p[q].N;
    }
    count += mt;
  }
  return count;
}

constexpr int kGemmStages = 4;
constexpr int kSlab = 64;                    // points per stage
constexpr int kBoxBytes = kSlab * 128;       // a 64-column bf16 box
constexpr int kStageBytes = 6 * kBoxBytes;   // A: 2 boxes, G: 4 boxes
constexpr int kGemmThreads = 256;            // two consumer warpgroups
constexpr size_t kGemmSmem = (size_t)kGemmStages * kStageBytes + 1024;

// Block u: tile u % n_tiles over the point range u / n_tiles (slabs
// [s per_split, (s + 1) per_split)); its partial goes to split copy s of
// gpart ([splits, w_mat], the packed dW layout).
__global__ void __launch_bounds__(kGemmThreads, 1)
    dw_gemm_kernel(const __grid_constant__ CUtensorMap map, Dims d,
                   int n_tiles, int slabs, int per_split, float* gpart,
                   long long w_mat) {
  __shared__ __align__(8) uint64_t full[kGemmStages];
  extern __shared__ unsigned char gsm_raw[];
  unsigned char* gsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gsm_raw) + 1023) & ~(uintptr_t)1023);
  const int t = blockIdx.x % n_tiles, s = blockIdx.x / n_tiles;
  GemmTile tile;
  gemm_tiles(d, t, &tile);
  const int slab0 = s * per_split;
  const int ns = max(0, min(slabs, slab0 + per_split) - slab0);
  const int wg = threadIdx.x / 128;
  const int n_a = tile.kv > 64 ? 2 : 1, n_g = (tile.nv + 63) / 64;
  const bool active = wg < n_a;
  const uint32_t tx = (uint32_t)(n_a + n_g) * kBoxBytes;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kGemmStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int st = it % kGemmStages, row = (slab0 + it) * kSlab;
    unsigned char* sb = gsm + st * kStageBytes;
    mbar_expect_tx(&full[st], tx);
    for (int a = 0; a < n_a; ++a)
      tma_load_2d(sb + a * kBoxBytes, &map, &full[st], tile.a_col + 64 * a,
                  row);
    for (int j = 0; j < n_g; ++j)
      tma_load_2d(sb + (2 + j) * kBoxBytes, &map, &full[st],
                  tile.g_col + 64 * j, row);
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < min(kGemmStages, ns); ++it) issue(it);

  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;

  for (int it = 0; it < ns; ++it) {
    const int st = it % kGemmStages;
    mbar_wait(&full[st], (it / kGemmStages) & 1);
    if (active) {
      const uint32_t sb = smem_u32(gsm + st * kStageBytes);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < kSlab / 16; ++k) {
        const uint64_t da = sw128_desc(sb + wg * kBoxBytes + k * 2048);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n_g)
            wgmma_64x64(acc[j], da,
                        sw128_desc(sb + (2 + j) * kBoxBytes + k * 2048));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    }
    __syncthreads();  // every warpgroup is done with stage st
    if (threadIdx.x == 0 && it + kGemmStages < ns) issue(it + kGemmStages);
  }

  if (!active) return;
  // Accumulator fragment of m64nN: register r of thread (warp w, lane l)
  // holds row 16 w + l / 4 (+ 8 for r % 4 >= 2), column 8 (r / 4) +
  // 2 (l % 4) (+ 1 for odd r).
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  float* out = gpart + (long long)s * w_mat + tile.dst;
  const int row = 64 * wg + 16 * w + lane / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n_g) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = 64 * j + 8 * nb + 2 * (lane % 4);
      if (col >= tile.nv) continue;
      if (row < tile.kv)
        *reinterpret_cast<float2*>(out + (long long)row * tile.ldd + col) =
            make_float2(acc[j][4 * nb], acc[j][4 * nb + 1]);
      if (row + 8 < tile.kv)
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * tile.ldd +
                                   col) =
            make_float2(acc[j][4 * nb + 2], acc[j][4 * nb + 3]);
    }
  }
}

// dw[j] = the split partials' sum in split order (j < w_mat, the dW
// matrices), else the walk blocks' partials in block order (the heads'
// dW, then the biases).
__global__ void level_reduce(const float* __restrict__ gpart, int splits,
                             long long w_mat, const float* __restrict__ part,
                             int blocks, long long stride, int total,
                             float* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  float s = 0.f;
  if (j < w_mat) {
    for (int b = 0; b < splits; ++b) s += gpart[(long long)b * w_mat + j];
  } else {
    for (int b = 0; b < blocks; ++b)
      s += part[(long long)b * stride + (j - w_mat)];
  }
  dw[j] = s;
}

// ---------------------------------------------------------------------------
// Host side: plan and launch
// ---------------------------------------------------------------------------

// The legacy plan (train_block, its dW in the walk) in the nine slots of
// level_plan: blocks, workspace elements, partial floats per block,
// shared memory, points per chunk, then 0 for the GEMM and the walk kind.
template <typename T, typename K>
int legacy_level_plan(K kernel, int mode, int n_rays, int seg,
                      const Dims& d, long long* out) {
  long long pl[4];
  const int err = plan<T>(kernel, mode, n_rays * seg, seg, d, pl);
  if (err) return err;
  out[0] = pl[0];
  out[1] = pl[0] * pl[1];
  out[2] = pl[2];
  out[3] = pl[3];
  out[4] = chunk_points(mode, seg);
  out[5] = out[6] = out[7] = out[8] = 0;
  return 0;
}

// The plan of one bf16 level. out[0..8]: walk blocks, workspace elements
// (the whole level), per-block partial floats, walk dynamic shared memory
// bytes, points per chunk, GEMM splits, split-partial floats, slabs per
// split, and 1: the level walk runs. A width over 256 (the weight ring's
// columns) or a shared memory that cannot hold the ring takes the legacy
// walk of the other train kernels instead (train_block with its dW pass,
// out[8] = 0).
template <typename K>
int level_plan(K walk, K legacy, int mode, int n_rays, int seg,
               const Dims& d, long long* out) {
  if (d.width % 16 || d.half % 16 || 2 * d.depth + 2 > kMaxProbs)
    return (int)cudaErrorInvalidValue;
  const int r_max = max(1, kChunk / seg);
  const size_t smem_max = level_smem(d, pad64(r_max * seg));
  if (d.width > kTileN || d.half > kTileN || smem_max > 232448)
    return legacy_level_plan<bf16>(legacy, mode, n_rays, seg, d, out);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk,
                                                      kThreads, smem_max);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = (long long)sms * per_sm;
  // Rays per chunk: the fewest rows for the slowest block (whole waves
  // of chunks times rows a chunk), the most rays among equals.
  int best_r = 1;
  long long best = -1;
  for (int r = 1; r <= r_max; ++r) {
    const long long chunks = (n_rays + r - 1) / r;
    const long long cost = (chunks + grid - 1) / grid * pad64(r * seg);
    if (best < 0 || cost <= best) {
      best = cost;
      best_r = r;
    }
  }
  const int cpts = best_r * seg, rows = pad64(cpts);
  const long long n_chunks = (n_rays + best_r - 1) / best_r;
  const long long slabs = n_chunks * rows / kSlab;
  const int tiles = gemm_tiles(d, -1, nullptr);
  long long splits = std::max(1LL, std::min(slabs, (4LL * sms + tiles - 1) /
                                                       tiles));
  const long long per_split = (slabs + splits - 1) / splits;
  splits = (slabs + per_split - 1) / per_split;
  err = cudaFuncSetAttribute(dw_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = std::min(n_chunks, grid);
  out[1] = n_chunks * rows * Cols(d).total;
  out[2] = (d.width + 3 * d.half + d.b_total() + 63) / 64 * 64;
  out[3] = (long long)level_smem(d, rows);
  out[4] = cpts;
  out[5] = splits;
  out[6] = splits * (long long)d.w_alpha();
  out[7] = per_split;
  out[8] = 1;
  return 0;
}

// After the walk: the dW GEMM over its workspace, then the reduction of
// its split partials and the walk's block partials into dw.
inline int level_dw(const Dims& d, const long long* pl, bf16* ws,
                    float* part, float* gpart, float* dw,
                    cudaStream_t stream) {
  const long long rows = pl[1] / Cols(d).total;
  const int splits = (int)pl[5], per_split = (int)pl[7];
  const int tiles = gemm_tiles(d, -1, nullptr);
  const long long w_mat = (long long)d.w_alpha();
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)Cols(d).total, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Cols(d).total * sizeof(bf16)};
  const cuuint32_t box[2] = {64, kSlab};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ws, dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // ---- the dW GEMM ----
  dw_gemm_kernel<<<tiles * splits, kGemmThreads, kGemmSmem, stream>>>(
      map, d, tiles, (int)(rows / kSlab), per_split, gpart, w_mat);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // ---- end of the dW GEMM ----
  const int total = (int)(d.w_total() + d.b_total());
  level_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      gpart, splits, w_mat, part, (int)pl[0], pl[2], total, dw);
  return (int)cudaGetLastError();
}

}  // namespace mlp
