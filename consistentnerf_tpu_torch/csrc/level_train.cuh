// The walk of the train kernels for Hopper: the one-pass levels #3
// (onepass_level.cu, mode 3) and #5 (onepass_mip_level.cu, mode 4), the
// weight grads for a given cotangent (mode 2) #2 (fused_mlp_bwd.cu), its
// row-major twin #11 (the same file), #7 (fused_mip_bwd.cu), its
// row-major twin #16 (the same file) and the v1 kernel #14
// (fused_mlp_v1_bwd.cu, with v1's heads on [pe | h]), and their dW
// product, in bf16; and in fp32 #3, #2 and #11 (the fp32 walk below: six
// bf16 products a fp32 product). The fp32 path of #5, #7, #14 and #16,
// widths over 256 and the normals (mode 5) keep mlp_train.cuh::
// train_block.
//
// What it replaces: train_block ran forward, (compositing,) backward AND
// the dW pass per 768-point chunk in one persistent block. Its dW pass
// loaded every fp32 dW block from the block's partial in device memory,
// accumulated 768 points with legacy wmma over slabs copied
// synchronously, and stored it back (2 x 2.4 MB of partial traffic per
// chunk; 132 partials of ~4.8 MB do not fit the 50 MB L2): half of the
// level's time (52 of 100 ms at the flagship step's fine level on an
// H100). Its walks loaded every weight fragment from L2 in each warp and
// waited on it (the backward walk a third of the time).
//
// A launch of these kernels now takes three:
//   1. level_walk: per chunk, the forward (saving every activation), the
//      output cotangent (mode 2: read from g [4, N], or [N, 4] in the
//      row-major layout, zero on the chunk's padded rows; modes 3 and 4:
//      compositing of whole rays, the per-ray loss cotangent and the
//      compositing VJP) and the backward (saving every rounded gradient),
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
//      workspace is the whole launch's, one bf16 row per point (Cols),
//      written with 16-byte stores. Widths over 256 (or a shared memory
//      too small for the ring) run the legacy walk
//      (mlp_train.cuh::train_block, its dW pass inside) instead.
//   2. dw_gemm: every dW matrix of the MLP as one split-K GEMM over the
//      launch's points, dW = A^T G with A the saved layer input [R, K] and
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
// and takes that many rows of device memory (7.8 GB at the fine level,
// 1.95 GB at #2's 196,608 patch points).
//
// Chunks: at most 768 points (whole rays in modes 3 and 4, any count in
// mode 2, whose "rays" are single points), and as many a chunk as keep
// the last wave of the walk's persistent grid full (level_plan): the fine
// level 4 rays of 192 (8 waves), the coarse level 8 rays of 64 (4 waves,
// where 12 rays made 2.6), a mip level 8 rays of 96; #2 at its fine
// patch shape 768 points (2 waves), at its coarse one 512 (1 wave).
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

// v rounded as the walk of type T rounds it (bf16), or as it is (fp32).
template <typename T>
__device__ inline float rnd_as(float v) {
  return sizeof(T) == sizeof(bf16) ? rnd(v) : v;
}

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

// Product q of a chunk's sequence (nsub sub-tiles). V1: the feature
// layer reads [pe | h] after a skip at the last trunk layer (its
// transpose then starts at the h rows).
template <bool V1 = false>
__host__ __device__ inline WProd wprod(const Dims& d, int q, int nsub) {
  const int nf = wprods_fwd(d), nb = wprods_bwd(d), W = d.width;
  const int hr = d.head_rows<V1>(), fr = (int)(d.w_feature() / W);
  if (q < nsub * nf) {
    const int f = q % nf;
    if (f < d.depth)
      return WProd{0, 0, (int)(d.w_layer(f) / W), d.rows(f), W};
    if (f == d.depth) return WProd{0, 0, fr, hr, W};
    return WProd{0, 1, 0, W + d.V, d.half};
  }
  const int b = (q - nsub * nf) % nb;
  if (b == 0) return WProd{1, 1, 0, d.half, W};
  if (b == 1) return WProd{1, 0, fr + hr - W, W, W};
  const int i = d.depth + 1 - b;
  return WProd{1, 0,
               (int)(d.w_layer(i) / W) + (d.skip_before(i) ? d.P : 0), W, W};
}

// Slabs of one product: a slab per 64 rows of its reduction (NP = 3, the
// fp32 walk: per 64 rows the lo, mid and hi planes, then once more per 64
// rows the hi plane; see wg_product3).
template <int NP = 1>
__host__ __device__ inline int wslabs(const WProd& p) {
  return (NP == 1 ? 1 : 4) * ((p.red + 63) / 64);
}

// Forward products a sub-tile in the weight stream: the bf16 walk's
// (NP = 1); none in the fp32 walk, whose forward runs on the CUDA cores.
template <int NP>
__host__ __device__ inline int wstream_fwd(const Dims& d) {
  return NP == 1 ? wprods_fwd(d) : 0;
}

// Product k of the stream's table (its forward products, then the
// backward's) as wprod numbers it.
template <bool V1, int NP>
__host__ __device__ inline WProd wstream_prod(const Dims& d, int k,
                                              int nsub) {
  const int nfs = wstream_fwd<NP>(d);
  return wprod<V1>(d, k < nsub * nfs ? k : nsub * wprods_fwd(d) + k -
                                               nsub * nfs, nsub);
}

// Slabs of one chunk's sequence.
template <bool V1 = false, int NP = 1>
__host__ __device__ inline int wslabs_chunk(const Dims& d, int nsub) {
  int n = 0;
  for (int q = 0; q < nsub * (wstream_fwd<NP>(d) + wprods_bwd(d)); ++q)
    n += wslabs<NP>(wstream_prod<V1, NP>(d, q, nsub));
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
// have released the slab that held the slot before. NP = 3: of a
// product's 4 n slabs (n = its 64-row steps), slab j < 3 n is rows 64
// (j / 3) of plane 2 - j % 3 (lo, mid, hi), slab 3 n + i rows 64 i of
// plane 0 (hi).
template <int NP = 1>
__device__ inline void wissue(WStream& st, const WMapsN<NP>& maps,
                              const Dims& d) {
  const int nf = wstream_fwd<NP>(d), nb = wprods_bwd(d), qf = st.nsub * nf;
  const WProd p = st.tab[st.q < qf ? st.q % nf : nf + (st.q - qf) % nb];
  const int slot = st.issued % kWStages;
  if (st.issued >= kWStages)
    mbar_wait(&st.empty[slot], (st.issued / kWStages - 1) & 1);
  unsigned char* dst = st.ring + slot * kWStage;
  const int nbx = (p.out + 63) / 64;
  int kj = st.j, plane = 0;
  if constexpr (NP == 3) {
    const int n3 = 3 * ((p.red + 63) / 64);
    kj = st.j < n3 ? st.j / 3 : st.j - n3;
    plane = st.j < n3 ? 2 - st.j % 3 : 0;
  }
  const CUtensorMap* map = &maps.m[2 * plane + p.map];
  mbar_expect_tx(&st.full[slot], (uint32_t)nbx * kWBox);
  for (int b = 0; b < nbx; ++b) {
    if (p.dir == 0)
      tma_load_2d(dst + b * kWBox, map, &st.full[slot], 64 * b,
                  p.row0 + 64 * kj);
    else
      tma_load_2d(dst + b * kWBox, map, &st.full[slot], 64 * kj,
                  p.row0 + 64 * b);
  }
  ++st.issued;
  --st.left;
  if (++st.j == wslabs<NP>(p)) {
    st.j = 0;
    if (++st.q == st.nsub * (nf + nb)) st.q = 0;
  }
}

// Slab u is done in this warpgroup: one arrival on its slot's empty
// barrier; thread 0 then refills the ring.
template <int NP = 1>
__device__ inline void wrelease(WStream& st, const WMapsN<NP>& maps,
                                const Dims& d, int u) {
  if (threadIdx.x % 128 == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(&st.empty[u % kWStages]))
                 : "memory");
  if (threadIdx.x == 0 && st.left > 0) wissue<NP>(st, maps, d);
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

// ---------------------------------------------------------------------------
// The fp32 walk: the backward and the dW on the tensor cores
// ---------------------------------------------------------------------------
//
// In fp32 the backward's products and every dW run on the bf16 tensor
// cores: every operand x is split into three bf16 terms, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid) (round to nearest even, as
// torch's float -> bfloat16), and a product A B runs as six products into
// the one fp32 accumulator, in a fixed order: over the whole reduction
// A_hi B_lo, A_mid B_mid, A_hi B_mid, A_lo B_hi, A_mid B_hi, then A_hi
// B_hi (wg_product3, dw_gemm_kernel: the accumulator rounds toward zero,
// so the large terms come last). The three dropped terms are at 2^-24 of
// the product, the accuracy of a fp32 product at highest precision (the
// TPU's scheme for one). x = hi + mid + lo exactly for every normal x
// above ~2^-100; below, mid and lo lose bits to bf16's subnormals. The
// weights come split by the host (three planes of the packed layout,
// fused_mlp_v2.py::split3) and stream by TMA as the bf16 walk's do, four
// slabs where it takes one; the 64-point tiles stay fp32 in shared memory
// and are split in registers into wgmma's A fragments; the workspace
// holds every saved row as three bf16 planes (the dW GEMM's operands,
// split once where they are saved).
//
// The forward runs on the CUDA cores (layer_f32) with the arithmetic of
// the other train kernels' fp32 layer (mlp_common.cuh::layer: each output
// a k-ordered fma chain, then the bias), so its activations, and the ReLU
// masks the backward takes from them, are the old walk's and agree with
// the fp32 matmul of the plain versions. A tensor-core forward was as
// accurate (1.4e-8 of sum |x w| from fp64 on the mean, a fp32 matmul
// 1.9e-8, on an H100) but not the same bits, and where a pre-activation
// lies that close to 0 the two sides take other masks: a few units of a
// few thousand points flipped, and each moved the dW by up to ~1e-3 of
// its norm, past the fp32 gates (tools/fp32_walk_diag.py counts such
// masks). The forward's second activation tile lives
// in the weight ring, which the stream fills only in the backward; the
// backward keeps one tile and runs every step in place (a product reads
// the tile, the block syncs, its epilogue writes the tile over).

// The fp32 walk's forward layer on the CUDA cores: dst[m, n] =
// act(bias[n] + the fma chain over k of [s0 | s1][m, k] Wt[k, n], in k
// order from 0), each output's arithmetic that of mlp_common.cuh::layer
// (the old walk's), so the activations are its bits. 64 rows by up to 256
// columns, 8 x 8 a thread (rows ty + 8 i, columns tx + 32 j): A broadcast
// from shared memory across the warp, the rows of Wt read coalesced, 64
// fmas a thread per 16 loads (the old layer: 32 per 12).
__device__ inline void layer_f32(Seg<float> s0, Seg<float> s1,
                                 const float* __restrict__ wt, int n_out,
                                 const float* __restrict__ bias, bool relu,
                                 float* dst, int ldd) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* w = wt;
  for (int sgi = 0; sgi < 2; ++sgi) {
    const Seg<float> sg = sgi ? s1 : s0;
#pragma unroll 2
    for (int k = 0; k < sg.k; ++k, w += n_out) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sg.buf[(ty + 8 * i) * sg.ld + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 32 * j;
        b[j] = c < n_out ? w[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 32 * j;
      if (c < n_out) {
        float v = acc[i][j] + bias[c];
        if (relu) v = fmaxf(v, 0.f);
        dst[(ty + 8 * i) * ldd + c] = v;
      }
    }
}

// (hi, mid, lo) of a pair: bf16x2 words, the first value in the low half.
__device__ inline void split2(float x0, float x1, uint32_t& hi,
                              uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16x2<false>(x0, x1);
  const float r0 = x0 - __uint_as_float(hi << 16),
              r1 = x1 - __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16x2<false>(r0, r1);
  lo = pack_bf16x2<false>(r0 - __uint_as_float(mid << 16),
                          r1 - __uint_as_float(mid & 0xffff0000u));
}

// An fp32 value from its three planes (ps elements apart), exactly: hi +
// mid and then + lo are both representable.
__device__ inline float unsplit(const bf16* p, size_t ps) {
  return (to_f(p[0]) + to_f(p[ps])) + to_f(p[2 * ps]);
}

// The next (backward) product of the stream on the fp32 tile [s0 | s1]:
// wg_product with six products a 16-deep step, in two passes over the
// reduction so that the accumulator takes the five products of the
// smaller terms while it is small, and the large ones (hi hi) last. The
// tensor cores round a fp32 accumulation toward zero, at half an ulp of
// the accumulator a wgmma on average: a step's six products one after the
// other on a grown accumulator left a product 8x further from fp64 than a
// fp32 matmul (1.5e-7 of sum |x w| against 1.9e-8); in two passes the
// products of the small terms add to an accumulator at 2^-8 of its end
// value, hi hi takes the bf16 walk's count of roundings, and the products
// come within 1.4e-8.
// Pass 1, per 64 rows of the reduction: the thread loads its A fragments
// (rows 16 w + l / 4 (+ 8), columns 2 (l % 4) (+ 1, + 8): 8-byte loads,
// conflict-free at row strides of 8 mod 32 floats) and splits them; the
// three slabs of B (lo, mid, hi) each run their products as they land,
// A_hi B_lo; A_mid B_mid, A_hi B_mid; A_lo B_hi, A_mid B_hi; and are
// released one group later. Pass 2, per 64 rows: A_hi B_hi on the hi
// slab streamed again (4 slabs a 64-row step in all).
template <int NBH>
__device__ inline void wg_product3(WStream& st, const WMapsN<3>& maps,
                                   const Dims& d, Seg<float> s0,
                                   Seg<float> s1, float (&acc)[2][32]) {
  const int tid = threadIdx.x, wg = tid / 128, w = (tid % 128) / 32;
  const int lane = tid % 32;
  const int red = s0.k + s1.k, n_k = (red + 63) / 64;
  const int r = 16 * w + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[bb][q] = 0.f;
  // The A fragments of rows [64 j, 64 j + 64) of the reduction, split.
  auto load_a = [&](int j, uint32_t (&a)[3][4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 64 * j + 16 * kk;
      const bool ok = k < red;
      const Seg<float> sg = ok && k >= s0.k ? s1 : s0;
      const int kc = ok ? (k < s0.k ? k : k - s0.k) : 0;
      const float* src = sg.buf + r * sg.ld + kc + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 v = make_float2(0.f, 0.f);
        if (ok)
          v = *reinterpret_cast<const float2*>(src + (q % 2) * 8 * sg.ld +
                                               (q / 2) * 8);
        split2(v.x, v.y, a[0][kk][q], a[1][kk][q], a[2][kk][q]);
      }
    }
  };
  // Slab u's products with A's planes [lo_a, hi_a] (hi 0, mid 1, lo 2),
  // largest plane index first; committed as one group, and slab u - 1
  // released once its group is done.
  auto run = [&](int u, const uint32_t (&a)[3][4][4], int first,
                 int last) {
    const int slot = u % kWStages;
    mbar_wait(&st.full[slot], (u / kWStages) & 1);
    const uint32_t sb = smem_u32(st.ring + slot * kWStage);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int bb = 0; bb < NBH; ++bb) {
        const int b = wg * NBH + bb;
        const uint64_t db = sw128_desc(sb + b * kWBox + kk * 32);
#pragma unroll
        for (int pa = 2; pa >= 0; --pa)
          if (pa <= first && pa >= last)
            wgmma_rs<0>(acc[bb], a[pa][kk], db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (u > st.t) {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      wrelease<3>(st, maps, d, u - 1);
    }
  };
  uint32_t a[3][4][4];  // [hi, mid, lo][16-deep step][register]
  for (int j = 0; j < n_k; ++j) {  // pass 1: the smaller terms
    load_a(j, a);
    const int u = st.t + 3 * j;
    run(u, a, 0, 0);      // B lo: A hi
    run(u + 1, a, 1, 0);  // B mid: A mid, A hi
    run(u + 2, a, 2, 1);  // B hi: A lo, A mid
  }
  for (int j = 0; j < n_k; ++j) {  // pass 2: A hi B hi
    load_a(j, a);
    run(st.t + 3 * n_k + j, a, 0, 0);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  wrelease<3>(st, maps, d, st.t + 4 * n_k - 1);
  st.t += 4 * n_k;
}

// Backward, fp32: wg_bwd's product and elementwise step with no rounding,
// in place (dst may be g). act: the hi plane of the layer's activations in
// the workspace (planes ps elements apart): act > 0 where hi > 0 (for
// every act above bf16's least subnormal, 2^-133); at TOP the alpha head's
// dW reads act itself (unsplit).
template <int NBH, bool MASK, bool TOP>
__device__ inline void wg_bwd3(WStream& st, const WMapsN<3>& maps,
                               const Dims& d, const float* g, int ldg,
                               int n_red, int k_out, const bf16* act,
                               int ldw, size_t ps, const float* ga_raw,
                               const float* __restrict__ wa, float* dst,
                               int ldd, float* csum, float* csum2, int ldc) {
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int row = 16 * ((tid % 128) / 32) + lane / 4;
  const int nbx = (k_out + 63) / 64;
  float acc[2][32];
  wg_product3<NBH>(st, maps, d, Seg<float>{g, ldg, n_red},
                   Seg<float>{nullptr, 0, 0}, acc);
  __syncthreads();
  const float ga[2] = {TOP ? ga_raw[row] : 0.f, TOP ? ga_raw[row + 8] : 0.f};
#pragma unroll
  for (int bb = 0; bb < NBH; ++bb) {
    const int b = wg * NBH + bb;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = 64 * b + 8 * n8 + 2 * (lane % 4);
      const bool in = b < nbx && col < k_out;
      float cs0 = 0.f, cs1 = 0.f, ca0 = 0.f, ca1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[bb][4 * n8 + 2 * h], v1 = acc[bb][4 * n8 + 2 * h + 1];
        float a0 = 0.f, a1 = 0.f;
        if (MASK && in) {
          const bf16* ap = act + (size_t)(row + 8 * h) * ldw + col;
          if (TOP) {
            a0 = unsplit(ap, ps);
            a1 = unsplit(ap + 1, ps);
          } else {
            const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap);
            a0 = __uint_as_float(a2 << 16);
            a1 = __uint_as_float(a2 & 0xffff0000u);
          }
        }
        if (TOP && in) {
          v0 = fmaf(ga[h], wa[col], v0);
          v1 = fmaf(ga[h], wa[col + 1], v1);
        }
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
          *reinterpret_cast<float2*>(dst + (row + 8 * h) * ldd + col) =
              make_float2(v0, v1);
        }
      }
      cs0 = rows16(cs0);
      cs1 = rows16(cs1);
      if (TOP) {
        ca0 = rows16(ca0);
        ca1 = rows16(ca1);
      }
      if (lane < 4 && in) {
        float* cp = csum + (tid / 32) * ldc + col;
        cp[0] = cs0;
        cp[1] = cs1;
        if (TOP) {
          cp = csum2 + (tid / 32) * ldc + col;
          cp[0] = ca0;
          cp[1] = ca1;
        }
      }
    }
  }
}

// Rows [row0, row0 + M) of an fp32 [M, cols] shared tile (ld) into the
// workspace columns [col0, col0 + cols) of its three planes (ps elements
// apart), split: 8 values a thread, a 16-byte store a plane.
template <int M>
__device__ inline void save_rows3(const float* src, int ld, int cols,
                                  bf16* ws, int ldw, size_t row0, int col0,
                                  size_t ps) {
  const int v = cols / 8;
  for (int e = threadIdx.x; e < M * v; e += kThreads) {
    const int p = e / v, c = (e % v) * 8;
    const float4 x0 = *reinterpret_cast<const float4*>(src + p * ld + c);
    const float4 x1 = *reinterpret_cast<const float4*>(src + p * ld + c + 4);
    uint32_t h[4], m[4], l[4];
    split2(x0.x, x0.y, h[0], m[0], l[0]);
    split2(x0.z, x0.w, h[1], m[1], l[1]);
    split2(x1.x, x1.y, h[2], m[2], l[2]);
    split2(x1.z, x1.w, h[3], m[3], l[3]);
    bf16* dst = ws + (row0 + p) * ldw + col0 + c;
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + ps) = make_uint4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<uint4*>(dst + 2 * ps) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Shared memory of one walk block, in bytes (must match the carve-up in
// level_walk): the weight ring (and its alignment slack), the tiles of T
// (pe, ve and two activation tiles in bf16, one in fp32), the per-chunk
// rows, the column-sum partials and, for row-major streams (`row`),
// encode_tile's staging of a tile's points (9 M floats).
template <typename T = bf16>
__host__ __device__ inline size_t level_smem(const Dims& d, int rows,
                                             bool row = false) {
  constexpr int M = 64, kActTiles = sizeof(T) == sizeof(bf16) ? 2 : 1;
  const int ac = d.act_cols();
  const size_t elems = (size_t)M * (d.P + kPad) + (size_t)M * (d.V + kPad) +
                       kActTiles * (size_t)M * (ac + kPad);
  const size_t floats = 4 * M + 5 * (size_t)rows +
                        2 * (size_t)kWarps * ac + (row ? 9 * M : 0);
  return (size_t)kWStages * kWStage + 1024 + elems * sizeof(T) +
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

// Planes of the weight stream and of the workspace: one in bf16, three
// (hi, mid, lo) in fp32.
template <typename T>
constexpr int kPlanes = sizeof(T) == sizeof(bf16) ? 1 : 3;

// One block's walk over its chunks of `cpts` points (whole rays; in mode
// 2 rr.seg = 1 and rr.n_rays = N). The partial of the block holds the
// packed grad from w_alpha<V1>() on: the alpha head's dW [head_rows], the
// rgb head's [3, H], then every bias. gin: mode 2's output cotangent
// [4, N], or [N, 4] in the row-major layout L (else unread). L: the
// layout of the point streams and of gin (mlp_common.cuh; row-major in
// mode 2 only). V1: the v1 kernels' heads, which read [pe | h] after a
// skip at the last trunk layer (Dims::head_skip). T: bf16, or float for
// the fp32 walk (six products a product; the workspace ws holds three
// bf16 planes of the launch's rows, `maps` the three weight planes'
// maps; wflat, the fp32 weights, serves the heads).
template <int MODE, typename Enc, typename L = ColMajor, bool V1 = false,
          typename T = bf16>
__device__ void level_walk(const float* __restrict__ pts,
                           const float* __restrict__ covs,
                           const float* __restrict__ views,
                           const float* __restrict__ gin, RayRows rr,
                           const T* __restrict__ wflat,
                           const float* __restrict__ bflat,
                           bf16* __restrict__ ws, float* part_all,
                           size_t part_stride, int cpts, Dims d,
                           const WMapsN<kPlanes<T>>& maps) {
  static_assert(MODE >= 2 && MODE <= 4, "the train modes 2, 3 and 4");
  static_assert(!L::kRow || MODE == 2, "row-major streams: mode 2 only");
  constexpr int NP = kPlanes<T>;
  constexpr bool F32 = NP == 3;
  static_assert(!(F32 && V1), "the fp32 walk: the v2 heads");
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
  // fp32: plane p of workspace row r at ws + p ps + r ldw.
  const size_t ps = F32 ? (size_t)(n + cpts - 1) / cpts * rows * ldw : 0;
  const int ldp = P + kPad, ldv = V + kPad, ldh = d.act_cols() + kPad;
  const int ldc = d.act_cols();
  T* pe = reinterpret_cast<T*>(ring + kWStages * kWStage);
  T* ve = pe + M * ldp;
  T* hx = ve + M * ldv;
  // fp32: one activation tile; the forward's second in the weight ring
  // (64 x ldh floats, 67.6 KB at most, in its 96 KB).
  T* hy = F32 ? reinterpret_cast<T*>(ring) : hx + M * ldh;
  float* graw = reinterpret_cast<float*>(hx + (F32 ? 1 : 2) * M * ldh);
  float* craw = graw + 4 * M;   // [4][rows] raw, then d_raw
  float* ctrans = craw + 4 * rows;  // [rows]
  float* csum = ctrans + rows;  // [2][kWarps][ldc] column-sum partials
  float* stage = csum + 2 * kWarps * ldc;  // row-major: [9][M] points

  // The heads read h, or [pe | h] after a skip at the last trunk layer
  // (V1); their h rows start at row hoff.
  const int hr = d.head_rows<V1>(), hoff = hr - W;
  float* ph = part_all + blockIdx.x * part_stride;  // heads' dW
  float* pb = ph + hr + 3 * H;                      // biases
  for (size_t j = threadIdx.x; j < part_stride; j += kThreads) ph[j] = 0.f;

  const T* w_a = wflat + d.w_alpha<V1>();
  const T* w_r = wflat + d.w_rgb<V1>();
  const int n_chunks = (n + cpts - 1) / cpts;

  // The weight stream: the bf16 walk's runs over the block's chunks from
  // the start; the fp32 walk's (backward products only) is started at
  // each chunk's backward, its forward holding the ring as a tile.
  WStream st{ring, wfull, wempty, wtab, rows / M, 0, 0, 0, 0, 0};
  if (threadIdx.x == 0) {
    const int mine = blockIdx.x < n_chunks
                         ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1
                         : 0;
    st.left = F32 ? 0 : mine * wslabs_chunk<V1, NP>(d, st.nsub);
    const int nfs = wstream_fwd<NP>(d), nb = wprods_bwd(d);
    for (int k = 0; k < nfs + nb; ++k)
      wtab[k] = wstream_prod<V1, NP>(
          d, k < nfs ? k : st.nsub * nfs + k - nfs, st.nsub);
    for (int k = 0; k < kWStages; ++k) {
      mbar_init(&wfull[k], 1);
      mbar_init(&wempty[k], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kWStages && st.left > 0; ++k)
      wissue<NP>(st, maps, d);
  }
  __syncthreads();

  // A tile's rows into the workspace: as they are (bf16), or split into
  // the three planes (fp32).
  auto save = [&](const T* src, int ld, int cols, size_t row0, int col0) {
    if constexpr (F32)
      save_rows3<M>(src, ld, cols, ws, ldw, row0, col0, ps);
    else
      save_rows<M>(src, ld, cols, ws, ldw, row0, col0);
  };
  // A forward layer product: wg_layer on the stream's slabs (bf16), or
  // layer_f32 on the fp32 weights wt (fp32).
  auto layer = [&](Seg<T> s0, Seg<T> s1, const T* wt, int n_out,
                   const float* bias, bool relu, T* dst) {
    if constexpr (F32)
      layer_f32(s0, s1, wt, n_out, bias, relu, dst, ldh);
    else
      wg_layer(st, maps, d, s0, s1, n_out, bias, relu, dst, ldh);
  };

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int base = c * cpts;
    const int valid = min(cpts, n - base);
    const size_t crow = (size_t)c * rows;
    // ---- forward over sub-tiles, saving every activation ----
    for (int r0 = 0; r0 < rows; r0 += M) {
      const int sub_valid = max(0, min(M, valid - r0));
      const size_t prow = crow + r0;
      encode_tile<T, M, Enc, L>(pts, covs, views, n, base + r0, sub_valid,
                                d, pe, ldp, ve, ldv, stage);
      __syncthreads();
      save(pe, ldp, P, prow, cl.pe);
      save(ve, ldv, V, prow, cl.ve);
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
        layer(s0, s1, wflat + d.w_layer(i), W, b, true, dst);
        __syncthreads();
        save(dst, ldh, W, prow, cl.act + i * W);
        h = dst;
        b += W;
      }
      // The heads, fp32 (mode 2 reads its cotangent instead).
      for (int p = threadIdx.x; MODE != 2 && p < M; p += kThreads) {
        float s = 0.f;
        for (int k = 0; k < hoff; ++k)
          s = fmaf(to_f(pe[p * ldp + k]), to_f(w_a[k]), s);
        for (int k = 0; k < W; ++k)
          s = fmaf(to_f(h[p * ldh + k]), to_f(w_a[hoff + k]), s);
        craw[3 * rows + r0 + p] = s + bflat[d.b_alpha()];
      }
      T* feat = (h == hx) ? hy : hx;
      layer(hoff ? Seg<T>{pe, ldp, P} : Seg<T>{h, ldh, W},
            hoff ? Seg<T>{h, ldh, W} : Seg<T>{nullptr, 0, 0},
            wflat + d.w_feature(), W, bflat + d.b_feature(), false, feat);
      __syncthreads();
      save(feat, ldh, W, prow, cl.feat);
      layer(Seg<T>{feat, ldh, W}, Seg<T>{ve, ldv, V}, wflat + d.w_views<V1>(),
            H, bflat + d.b_views(), true, h);
      __syncthreads();
      save(h, ldh, H, prow, cl.hv);
      for (int e = threadIdx.x; MODE != 2 && e < 3 * M; e += kThreads) {
        const int p = e % M, cc = e / M;
        float s = 0.f;
        for (int k = 0; k < H; ++k)
          s = fmaf(to_f(h[p * ldh + k]), to_f(w_r[cc * H + k]), s);
        craw[cc * rows + r0 + p] = s + bflat[d.b_rgb() + cc];
      }
      __syncthreads();
    }

    // ---- the output cotangent: read (mode 2), or compositing and the
    // per-ray loss cotangent ----
    if (MODE == 2) {
      // Exactly 0 past the chunk's points: the padded rows' activations
      // are not (bias through ReLU), and the dW GEMM sums every row.
      if constexpr (L::kRow) {
        // g [N, 4]: a point's 4 floats in one 16-byte load (where g is
        // 16-byte aligned, as a fresh tensor is), consecutive threads on
        // consecutive points.
        const bool v4 = (reinterpret_cast<uintptr_t>(gin) & 15) == 0;
        for (int p = threadIdx.x; p < rows; p += kThreads) {
          const size_t g = (size_t)base + p;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p < valid)
            v = v4 ? __ldg(reinterpret_cast<const float4*>(gin) + g)
                   : make_float4(gin[L::at(0, g, n, 4)],
                                 gin[L::at(1, g, n, 4)],
                                 gin[L::at(2, g, n, 4)],
                                 gin[L::at(3, g, n, 4)]);
          craw[p] = v.x;
          craw[rows + p] = v.y;
          craw[2 * rows + p] = v.z;
          craw[3 * rows + p] = v.w;
        }
      } else {
        for (int e = threadIdx.x; e < 4 * rows; e += kThreads) {
          const int k = e / rows, p = e % rows;
          craw[e] = p < valid ? gin[L::at(k, (size_t)base + p, n, 4)] : 0.f;
        }
      }
      __syncthreads();
    }
    if (MODE == 3) vanilla_composite(rr, c, cpts, rows, craw, ctrans);
    if (MODE == 4) mip_composite(rr, c, cpts, rows, craw, ctrans);
    if constexpr (F32) {
      // The ring leaves the forward (its generic accesses ordered before
      // the copies into it) and takes the chunk's backward slabs.
      fence_proxy_async();
      __syncthreads();
      if (threadIdx.x == 0) {
        st.left = wslabs_chunk<V1, NP>(d, st.nsub);
        for (int k = 0; k < kWStages && st.left > 0; ++k)
          wissue<NP>(st, maps, d);
      }
    }

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
      // kept in hy for the rgb head's dW (bf16), or read from the
      // workspace's planes (fp32: hy is hx).
      const int h8 = H / 8;
      for (int e = threadIdx.x; e < M * h8; e += kThreads) {
        const int p = e / h8, j0 = (e % h8) * 8;
        const uint4 hv8 = *reinterpret_cast<const uint4*>(
            ws + (prow + p) * ldw + cl.hv + j0);
        if constexpr (!F32)
          *reinterpret_cast<uint4*>(hy + p * ldh + j0) = hv8;
        const float g0 = rnd_as<T>(graw[p]), g1 = rnd_as<T>(graw[M + p]),
                    g2 = rnd_as<T>(graw[2 * M + p]);
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
        if constexpr (F32) {
          float* o = hx + p * ldh + j0;
          *reinterpret_cast<float4*>(o) =
              make_float4(o8[0], o8[1], o8[2], o8[3]);
          *reinterpret_cast<float4*>(o + 4) =
              make_float4(o8[4], o8[5], o8[6], o8[7]);
        } else {
          const uint4 ov = pack8(o8);
          *reinterpret_cast<uint4*>(hx + p * ldh + j0) = ov;
          *reinterpret_cast<uint4*>(ws + (prow + p) * ldw + cl.ghv + j0) =
              ov;
        }
      }
      __syncthreads();
      if constexpr (F32) save(hx, ldh, H, prow, cl.ghv);
      for (int j = threadIdx.x; j < H; j += kThreads) {
        // The bias sum of g_hv (recomputed as above) and the rgb head's
        // dW, hv^T round(g_rgb).
        const float w0 = to_f(w_r[j]), w1 = to_f(w_r[H + j]),
                    w2 = to_f(w_r[2 * H + j]);
        float colsum = 0.f, s[3] = {0.f, 0.f, 0.f};
        for (int p = 0; p < M; ++p) {
          const float hv =
              F32 ? unsplit(ws + (prow + p) * ldw + cl.hv + j, ps)
                  : to_f(hy[p * ldh + j]);
          const float g0 = rnd_as<T>(graw[p]), g1 = rnd_as<T>(graw[M + p]),
                      g2 = rnd_as<T>(graw[2 * M + p]);
          float v = fmaf(g2, w2, fmaf(g1, w1, fmaf(g0, w0, 0.f)));
          if (!(hv > 0.f)) v = 0.f;
          colsum += v;
          s[0] = fmaf(hv, g0, s[0]);
          s[1] = fmaf(hv, g1, s[1]);
          s[2] = fmaf(hv, g2, s[2]);
        }
        pb[d.b_views() + j] += colsum;
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) ph[hr + cc * H + j] += s[cc];
      }
      // V1 at a head skip: the alpha head's dW on its pe rows, pe^T
      // round(g_alpha).
      for (int j = threadIdx.x; j < hoff; j += kThreads) {
        float s = 0.f;
        for (int p = 0; p < M; ++p)
          s = fmaf(to_f(ws[(prow + p) * ldw + cl.pe + j]),
                   rnd_as<T>(graw[3 * M + p]), s);
        ph[j] += s;
      }
      __syncthreads();
      // The products fused with the elementwise steps they feed (see
      // wg_bwd): g_feat = round(g_hv) Wv[feature rows]^T, rounded into
      // hy; g_h = round(g_feat) Wf^T + round(g_alpha) wa, masked by the
      // top layer's activations and rounded into hx; then down the
      // trunk. Each step's rounded tile goes to the workspace. (fp32:
      // wg_bwd3, no rounding, every step in place in hx.)
      const int nbh = (W + 63) / 64 > 2 ? 2 : 1;
      auto step = [&](auto mask, auto top, const T* g, int n_red,
                      const bf16* act, T* dst, int bias_off, int ws_col) {
        constexpr bool kMask = decltype(mask)::value;
        constexpr bool kTop = decltype(top)::value;
        if constexpr (F32) {
          if (nbh == 2)
            wg_bwd3<2, kMask, kTop>(st, maps, d, g, ldh, n_red, W, act, ldw,
                                    ps, graw + 3 * M, w_a + hoff, dst, ldh,
                                    csum, csum + kWarps * ldc, ldc);
          else
            wg_bwd3<1, kMask, kTop>(st, maps, d, g, ldh, n_red, W, act, ldw,
                                    ps, graw + 3 * M, w_a + hoff, dst, ldh,
                                    csum, csum + kWarps * ldc, ldc);
        } else {
          if (nbh == 2)
            wg_bwd<2, kMask, kTop>(st, maps, d, g, ldh, n_red, W, act, ldw,
                                   graw + 3 * M, w_a + hoff, dst, ldh, csum,
                                   csum + kWarps * ldc, ldc);
          else
            wg_bwd<1, kMask, kTop>(st, maps, d, g, ldh, n_red, W, act, ldw,
                                   graw + 3 * M, w_a + hoff, dst, ldh, csum,
                                   csum + kWarps * ldc, ldc);
        }
        __syncthreads();
        for (int j = threadIdx.x; j < W; j += kThreads) {
          pb[bias_off + j] += wg_colsum(csum, ldc, j, nbh);
          if (kTop)
            ph[hoff + j] += wg_colsum(csum + kWarps * ldc, ldc, j, nbh);
        }
        save(dst, ldh, W, prow, ws_col);
        __syncthreads();
      };
      using F = std::false_type;
      using Tr = std::true_type;
      T* hb = F32 ? hx : hy;  // the backward's second tile
      step(F{}, F{}, hx, H, nullptr, hb, d.b_feature(), cl.gfeat);
      const bf16* act_top = ws + prow * ldw + cl.act + (d.depth - 1) * W;
      step(Tr{}, Tr{}, hb, W, act_top, hx, d.b_layer(d.depth - 1),
           cl.gpre + (d.depth - 1) * W);
      T* cur = hx;
      for (int i = d.depth - 1; i > 0; --i) {
        T* other = (cur == hx) ? hb : hx;
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

// V1: at a head skip the feature layer's dW is two problems, its pe rows
// and its h rows, as a post-skip trunk layer's.
template <bool V1 = false>
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
  const long long wf = (long long)d.w_feature();
  const int hoff = d.head_rows<V1>() - W;
  if (hoff) p[k++] = GemmProb{cl.pe, P, cl.gfeat, W, wf};
  p[k++] = GemmProb{cl.act + (d.depth - 1) * W, W, cl.gfeat, W,
                    wf + (long long)hoff * W};
  const long long wv = (long long)d.w_views<V1>();
  p[k++] = GemmProb{cl.feat, W, cl.ghv, d.half, wv};
  p[k++] = GemmProb{cl.ve, d.V, cl.ghv, d.half, wv + (long long)W * d.half};
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
template <bool V1 = false>
__host__ __device__ inline int gemm_tiles(const Dims& d, int t,
                                          GemmTile* out) {
  GemmProb p[kMaxProbs];
  const int np = gemm_probs<V1>(d, p);
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

// The GEMM's shape by the workspace's planes: NP = 1 (bf16) 4 stages of
// 64-point slabs; NP = 3 (fp32) 3 stages of 32-point slabs, each holding
// the slab's A and G boxes of all three planes (72 KB), six products a
// 16-point step, and at most kMaxSlabs slabs a split (4096 points: the
// accumulator's rounding toward zero, half an ulp a wgmma, stays under
// 1e-5 of a dW there; more splits where the launch has more points).
template <int NP>
struct Gemm {
  static constexpr int kStages = NP == 1 ? 4 : 3;
  static constexpr int kSlab = NP == 1 ? 64 : 32;   // points per stage
  static constexpr int kBoxBytes = kSlab * 128;     // a 64-column bf16 box
  static constexpr int kStageBytes = NP * 6 * kBoxBytes;  // A 2, G 4 boxes
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024;
  static constexpr long long kMaxSlabs = NP == 1 ? 1LL << 40 : 128;
};
constexpr int kGemmThreads = 256;  // two consumer warpgroups

// Block u: tile u % n_tiles over the point range u / n_tiles (slabs
// [s per_split, (s + 1) per_split)); its partial goes to split copy s of
// gpart ([splits, w_mat], the packed dW layout). NP = 3: the map covers
// the workspace's three planes, plane p's rows from p plane_rows, and the
// block walks its range twice (the walk's order): first the five products
// of the smaller terms, A_hi G_lo, A_mid G_mid, A_hi G_mid, A_lo G_hi,
// A_mid G_hi, from all three planes' boxes; then A_hi G_hi from the hi
// planes' alone.
template <bool V1, int NP = 1>
__global__ void __launch_bounds__(kGemmThreads, 1)
    dw_gemm_kernel(const __grid_constant__ CUtensorMap map, Dims d,
                   int n_tiles, int slabs, int per_split, float* gpart,
                   long long w_mat, int plane_rows) {
  using G = Gemm<NP>;
  __shared__ __align__(8) uint64_t full[G::kStages];
  extern __shared__ unsigned char gsm_raw[];
  unsigned char* gsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gsm_raw) + 1023) & ~(uintptr_t)1023);
  const int t = blockIdx.x % n_tiles, s = blockIdx.x / n_tiles;
  GemmTile tile;
  gemm_tiles<V1>(d, t, &tile);
  const int slab0 = s * per_split;
  const int ns = max(0, min(slabs, slab0 + per_split) - slab0);
  const int wg = threadIdx.x / 128;
  const int n_a = tile.kv > 64 ? 2 : 1, n_g = (tile.nv + 63) / 64;
  const bool active = wg < n_a;
  // Stages of the block: its slabs, once (bf16) or twice (fp32: the
  // second pass loads the hi planes only).
  const int n_it = NP == 1 ? ns : 2 * ns;

  if (threadIdx.x == 0) {
    for (int st = 0; st < G::kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int pass = it >= ns, st = it % G::kStages;
    const int row = (slab0 + it - pass * ns) * G::kSlab;
    const int planes = pass ? 1 : NP;
    unsigned char* sb = gsm + st * G::kStageBytes;
    mbar_expect_tx(&full[st],
                   (uint32_t)(planes * (n_a + n_g)) * G::kBoxBytes);
    for (int p = 0; p < planes; ++p) {
      unsigned char* pb = sb + p * 6 * G::kBoxBytes;
      for (int a = 0; a < n_a; ++a)
        tma_load_2d(pb + a * G::kBoxBytes, &map, &full[st],
                    tile.a_col + 64 * a, p * plane_rows + row);
      for (int j = 0; j < n_g; ++j)
        tma_load_2d(pb + (2 + j) * G::kBoxBytes, &map, &full[st],
                    tile.g_col + 64 * j, p * plane_rows + row);
    }
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < min(G::kStages, n_it); ++it) issue(it);

  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;

  // (A plane, G plane) of each product of a step (planes hi 0, mid 1,
  // lo 2): pass 0's, then pass 1's (NP = 3); bf16 hi hi alone.
  constexpr int kPairs = NP == 1 ? 1 : 5;
  constexpr int kPa[5] = {0, 1, 0, 2, 1}, kPg[5] = {2, 1, 1, 0, 0};
  for (int it = 0; it < n_it; ++it) {
    const int st = it % G::kStages;
    const bool small = NP == 3 && it < ns;  // pass 0 of the fp32 GEMM
    mbar_wait(&full[st], (it / G::kStages) & 1);
    if (active) {
      const uint32_t sb = smem_u32(gsm + st * G::kStageBytes);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < G::kSlab / 16; ++k) {
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          if (q > 0 && !small) break;
          const int pa = small ? kPa[q] : 0, pg = small ? kPg[q] : 0;
          const uint64_t da = sw128_desc(
              sb + (pa * 6 + wg) * G::kBoxBytes + k * 2048);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < n_g)
              wgmma_64x64(acc[j], da,
                          sw128_desc(sb + (pg * 6 + 2 + j) * G::kBoxBytes +
                                     k * 2048));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    }
    __syncthreads();  // every warpgroup is done with stage st
    if (threadIdx.x == 0 && it + G::kStages < n_it) issue(it + G::kStages);
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
template <typename T, bool V1 = false, typename K>
int legacy_level_plan(K kernel, int mode, int n_rays, int seg,
                      const Dims& d, long long* out) {
  long long pl[4];
  const int err = plan<T, V1>(kernel, mode, n_rays * seg, seg, d, pl);
  if (err) return err;
  out[0] = pl[0];
  out[1] = pl[0] * pl[1];
  out[2] = pl[2];
  out[3] = pl[3];
  out[4] = chunk_points(mode, seg);
  out[5] = out[6] = out[7] = out[8] = 0;
  return 0;
}

// The plan of one launch of type T (bf16, or float: the fp32 walk): a
// level of n_rays rays of seg samples (in mode 2, N points as N rays of
// one). out[0..8]: walk blocks, workspace elements (bf16, the whole
// launch: in fp32 its three planes), per-block partial floats, walk
// dynamic shared memory bytes, points per chunk, GEMM splits, split-partial
// floats, slabs per split (64 points in bf16, 32 in fp32), and 1: the
// level walk runs. A width over 256 (the weight ring's columns) or a
// shared memory that cannot hold the ring and the tiles (with the walk's
// static shared memory) takes the legacy walk of the other train kernels
// instead (train_block with its dW pass, out[8] = 0). L: the streams'
// layout (row-major staging counts in the shared memory); V1: the v1
// kernels' heads.
template <typename L = ColMajor, bool V1 = false, typename T = bf16,
          typename K>
int level_plan(K walk, K legacy, int mode, int n_rays, int seg,
               const Dims& d, long long* out) {
  constexpr int NP = kPlanes<T>;
  if (d.width % 16 || d.half % 16 ||
      2 * d.depth + 2 + (V1 && d.head_skip()) > kMaxProbs)
    return (int)cudaErrorInvalidValue;
  const int r_max = max(1, kChunk / seg);
  const size_t smem_max = level_smem<T>(d, pad64(r_max * seg), L::kRow);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, walk);
  if (err != cudaSuccess) return (int)err;
  if (d.width > kTileN || d.half > kTileN ||
      smem_max + fa.sharedSizeBytes > 232448)
    return legacy_level_plan<T, V1>(legacy, mode, n_rays, seg, d, out);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaFuncSetAttribute(
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
  const long long slabs = n_chunks * rows / Gemm<NP>::kSlab;
  const int tiles = gemm_tiles<V1>(d, -1, nullptr);
  long long splits = std::max(
      std::max(1LL, std::min(slabs, (4LL * sms + tiles - 1) / tiles)),
      (slabs + Gemm<NP>::kMaxSlabs - 1) / Gemm<NP>::kMaxSlabs);
  const long long per_split = (slabs + splits - 1) / splits;
  splits = (slabs + per_split - 1) / per_split;
  err = cudaFuncSetAttribute(dw_gemm_kernel<V1, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Gemm<NP>::kSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = std::min(n_chunks, grid);
  out[1] = NP * n_chunks * rows * Cols(d).total;
  out[2] = (d.head_rows<V1>() + 3 * d.half + d.b_total<V1>() + 63) / 64 * 64;
  out[3] = (long long)level_smem<T>(d, rows, L::kRow);
  out[4] = cpts;
  out[5] = splits;
  out[6] = splits * (long long)d.w_alpha<V1>();
  out[7] = per_split;
  out[8] = 1;
  return 0;
}

// After the walk: the dW GEMM over its workspace (NP planes of its rows),
// then the reduction of its split partials and the walk's block partials
// into dw.
template <bool V1 = false, int NP = 1>
int level_dw(const Dims& d, const long long* pl, bf16* ws, float* part,
             float* gpart, float* dw, cudaStream_t stream) {
  const long long rows = pl[1] / (NP * (long long)Cols(d).total);
  const int splits = (int)pl[5], per_split = (int)pl[7];
  const int tiles = gemm_tiles<V1>(d, -1, nullptr);
  const long long w_mat = (long long)d.w_alpha<V1>();
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)Cols(d).total,
                              (cuuint64_t)(NP * rows)};
  const cuuint64_t strides[1] = {(cuuint64_t)Cols(d).total * sizeof(bf16)};
  const cuuint32_t box[2] = {64, Gemm<NP>::kSlab};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ws, dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // ---- the dW GEMM ----
  dw_gemm_kernel<V1, NP>
      <<<tiles * splits, kGemmThreads, Gemm<NP>::kSmem, stream>>>(
          map, d, tiles, (int)(rows / Gemm<NP>::kSlab), per_split, gpart,
          w_mat, (int)rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // ---- end of the dW GEMM ----
  const int total = (int)(d.w_total<V1>() + d.b_total<V1>());
  level_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      gpart, splits, w_mat, part, (int)pl[0], pl[2], total, dw);
  return (int)cudaGetLastError();
}

// One train launch by its nine-slot plan pl: the level walk `walk` (pl[8]
// = 1; the weight maps made here over wt, the NP bf16 weight planes: w
// itself in bf16) then the dW GEMM and the reduction, or `legacy`
// (train_block with its dW pass) then the reduction of its block
// partials. Both kernels take (lead..., w, b, ws, part, part_stride, cpts,
// d, maps). V1: the v1 kernels' packed layout; NP = 3: the fp32 walk.
template <typename T, bool V1 = false, int NP = 1, typename K,
          typename... Lead>
int level_launch(K walk, K legacy, const long long* pl, const Dims& d,
                 const void* w, const void* wt, const void* b, void* ws,
                 void* part, void* gpart, void* dw, cudaStream_t stream,
                 Lead... lead) {
  WMapsN<NP> maps = {};
  K kernel = legacy;
  if (pl[8]) {
    const int err =
        weight_maps<V1, NP>(d, static_cast<const bf16*>(wt), &maps);
    if (err) return err;
    kernel = walk;
  }
  kernel<<<(int)pl[0], kThreads, (size_t)pl[3], stream>>>(
      lead..., static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(ws), static_cast<float*>(part), (size_t)pl[2],
      (int)pl[4], d, maps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (pl[8])
    return level_dw<V1, NP>(d, pl, static_cast<bf16*>(ws),
                        static_cast<float*>(part),
                        static_cast<float*>(gpart), static_cast<float*>(dw),
                        stream);
  const int total = (int)(d.w_total<V1>() + d.b_total<V1>());
  mlp_train_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), (int)pl[0], (size_t)pl[2], total,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace mlp
