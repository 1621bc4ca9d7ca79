// The fp32 forward walk of kernels #1 (fused_mlp_fwd.cu, the NeRFMLP) and
// #6 (fused_mip_fwd.cu, the MipMLP) for Hopper, and of their row-major
// twins #10 (fused_mlp_fwd_row), #12 / #13 (fused_mlp_v1_fwd.cu, at #1's
// shapes) and #15 (fused_mip_fwd_row): the forwards of every fp32 preset's
// train step. It computes mlp_fwd.cuh::fwd_tile's function with its bits,
// on the CUDA cores, at widths 64-256 in steps of 64; the dispatch of all
// five kernels (the bf16 walk of fwd_hopper.cuh, this walk, or fwd_tile)
// is at the end of this file.
//
// Why the CUDA cores and fwd_tile's bits: in an fp32 train step the kernel
// after this forward (#2 / #7 / #11 / #16 in mode 2) recomputes the trunk
// with level_train.cuh::layer_f32, whose arithmetic is fwd_tile's. With the
// same bits here, the loss these forwards give and the gradient those
// kernels take come from the same activations, and the walk is checked
// against the old one bit for bit. (A tensor-core fp32 forward took other
// ReLU masks than the CUDA-core one; PERF.md, PR 22.)
//
// What fwd_tile lost its time to, and what this walk does about it:
//   * Weights from L2 inside the k loop, no staging, one block of 8 warps
//     an SM. Here the weights come through a ring of `stages` slabs in
//     shared memory (16 k-rows x the product's N columns, 16 KB at N =
//     256): thread 256 (the producer warp) issues one bulk copy a slab
//     (cp.async.bulk, the packed rows of a slab are contiguous, so no
//     tensor map) under full / empty mbarriers, in the fixed order of the
//     products, tile after tile, running ahead of the consumers.
//   * Two column passes of 128 at width 256, each re-reading the tile and
//     the weights: here each consumer thread holds an 8 x TN block of
//     outputs (TN = N / 32: 8 x 8 at N = 256) over the whole N, so a
//     product reads its A and each slab once. A k step of a thread: two
//     float4 loads of A (rows 4 g .. 4 g + 3 and 32 + 4 g .., the tile kept
//     feature-major, so a warp's four row groups read one 64-byte line
//     and broadcast), TN / 4 float4 loads of B (eight column groups of a
//     warp read 128 contiguous bytes), 8 TN fmas.
//   * Two [M, W] activation buffers (172-180 KB at M = 64): here one
//     activation tile, updated in place. A product's outputs stay in
//     registers until every consumer has read the tile (a named barrier),
//     then the epilogue writes them over it, as the level walk's backward
//     does. Its row stride is 68 floats, so the epilogue's float4 stores
//     (four rows of one column) hit every bank once a quarter-warp.
//   * Each tile a non-persistent block, its encoding before its products:
//     here one persistent block an SM walks tiles b, b + grid, ...; the
//     producer's warps 1-3 encode the next tile's pe into a second pe
//     buffer and its view encoding into ve while the consumers multiply
//     (fwd_hopper.cuh's encoders, FhEnc, with an fp32 store).
//   * Serial heads with 64 of 256 threads busy: the heads keep their
//     serial column-order dots (their bits), but run while the other warps
//     multiply: alpha (threads 0-63) at the start of the feature product,
//     which overwrites h only after the barrier, and rgb (threads 0-191)
//     of the previous tile at the start of the next tile's layer 0, which
//     reads pe only: 256 and 128 serial fmas a thread against a tile's
//     ~150,000 a consumer thread.
//
// Rounding is fwd_tile's: the encodings in fp32 with the same values (FhEnc
// claims sinf's, cosf's and safe_sin's bits; fused_mlp_fwd.cu's
// fwd_f32_encode_check holds them against mlp_common.cuh's encoders on the
// card); each trunk, feature and view output is one fmaf chain over k from
// 0 across [s0 | s1] (the skip's [pe | h], the view layer's [feature |
// ve], the padded rows included), then + bias, then ReLU (none for the
// feature); alpha the column-order chain over h then + its bias, rgb the
// k-ordered chain over the view layer's output then + its bias. No
// split-K, no reordered sums, no cross-block reduction: two launches give
// the same bits, and the row-major layout (L) changes where a value is read
// and stored, not its value: #10 and #12 / #13 give #1's bits, #15 #6's.
//
// Shared memory (FfSmem, mirrored by ops/fused_mlp.py::fwd_walk_smem_bytes)
// at the mip's 8 x 256, 16 frequencies: a 4-slot ring 65,536 B, the
// activation tile 256 x 68 floats 69,632, two pe buffers 2 x 96 x 68 floats
// 52,224, ve 32 x 68 floats 8,704, the head weights 2,560, the barriers:
// 198,768 B; the plan takes two pe buffers and the deepest ring of 4 to 2
// slots that fits, else one pe buffer.

#pragma once

#include "fwd_hopper.cuh"

namespace mlp {

constexpr int kFfTile = 64;       // points a tile
constexpr int kFfThreads = 384;   // consumers 0-255, producer 256-383
constexpr int kFfConsumers = 256;
constexpr int kFfLd = kFfTile + 4;  // floats a feature row of a tile
constexpr int kFfSlab = 16;         // k-rows a weight slab
constexpr int kFfMaxStages = 4;

// Byte offsets of the shared-memory regions.
struct FfSmem {
  int ring, act, pe, ve, wa, wr, bars, total;
  __host__ __device__ FfSmem(const Dims& d, int stages, int npe) {
    const int na = d.width > d.half ? d.width : d.half;
    int o = 0;
    ring = o; o += stages * kFfSlab * na * 4;
    act = o; o += na * kFfLd * 4;
    pe = o; o += npe * d.P * kFfLd * 4;
    ve = o; o += d.V * kFfLd * 4;
    wa = o; o += 4 * d.width;
    wr = o; o += (12 * d.half + 15) / 16 * 16;
    bars = o; o += (2 * stages + 6) * 8;
    total = o;
  }
};

// The stores of this walk's encoders: fp32 into a feature-major tile.
struct FfStore {
  float* buf;
  __device__ void operator()(int p, int c, float v) const {
    buf[c * kFfLd + p] = v;
  }
};

// Column jj (0 .. TN - 1) of column group c (0 .. 31) in a product of N =
// 32 TN columns: TN / 4 blocks of four columns, then a pair where TN % 4 >=
// 2, then one column where TN is odd; a block of width v starting at
// column s (32 times the widths before it) holds columns s + v c .. s +
// v c + v - 1.
template <int TN>
__device__ inline int ff_col(int jj, int c) {
  constexpr int n4 = TN / 4, r = TN % 4;
  if (jj < 4 * n4) return 128 * (jj / 4) + 4 * c + jj % 4;
  if (r >= 2 && jj < 4 * n4 + 2) return 128 * n4 + 2 * c + (jj - 4 * n4);
  return 128 * n4 + (r >= 2 ? 64 : 0) + c;
}

// This thread's TN weights of one k-row of a slab (columns ff_col).
template <int TN>
__device__ inline void ff_load_b(const float* row, int c, float (&bv)[TN]) {
  constexpr int n4 = TN / 4, r = TN % 4;
#pragma unroll
  for (int i = 0; i < n4; ++i) {
    const float4 q = *reinterpret_cast<const float4*>(row + 128 * i + 4 * c);
    bv[4 * i] = q.x;
    bv[4 * i + 1] = q.y;
    bv[4 * i + 2] = q.z;
    bv[4 * i + 3] = q.w;
  }
  if constexpr (r >= 2) {
    const float2 q = *reinterpret_cast<const float2*>(row + 128 * n4 + 2 * c);
    bv[4 * n4] = q.x;
    bv[4 * n4 + 1] = q.y;
  }
  if constexpr (r % 2) bv[TN - 1] = row[128 * n4 + (r >= 2 ? 64 : 0) + c];
}

// The weight ring as the consumers read it: t counts the slabs consumed.
struct FfRing {
  const float* buf;
  int slot_floats, stages, t;
  uint64_t* full;
  uint64_t* empty;
};

// One product of the stream and its epilogue, on the tile in place: act =
// act_fn(bias + [s0 (k0 rows) | s1 (k1 rows)] Wt), N = 32 TN columns, each
// output one fmaf chain over k from 0. s0 / s1 point at their feature row
// 0; this thread holds rows 4 g .. 4 g + 3 and 32 + 4 g .. 32 + 4 g + 3 by
// columns ff_col<TN>(., c). pre() runs before this thread's products (a
// head on the tile); post() after every consumer has read the tile and
// before the epilogue writes it.
template <int TN, bool RELU, typename Pre, typename Post>
__device__ inline void ff_layer(const float* s0, int k0, const float* s1,
                                int k1, const float* __restrict__ bias,
                                float* act, FfRing& r, int c, int g, Pre pre,
                                Post post) {
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  pre();
  const int ns = (k0 + k1) / kFfSlab;
  for (int j = 0; j < ns; ++j) {
    const int u = r.t + j, slot = u % r.stages;
    mbar_wait(&r.full[slot], (u / r.stages) & 1);
    const float* bs = r.buf + slot * r.slot_floats;
    const int k = kFfSlab * j;
    const float* a = (k < k0 ? s0 + k * kFfLd : s1 + (k - k0) * kFfLd) + 4 * g;
#pragma unroll
    for (int kk = 0; kk < kFfSlab; ++kk) {
      // ---- k step ----
      const float4 x0 = *reinterpret_cast<const float4*>(a + kk * kFfLd);
      const float4 x1 = *reinterpret_cast<const float4*>(a + kk * kFfLd + 32);
      const float av[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float bv[TN];
      ff_load_b<TN>(bs + kk * 32 * TN, c, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      // ---- end of the k step ----
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&r.empty[slot]);
  }
  r.t += ns;
  float bb[TN];
#pragma unroll
  for (int jj = 0; jj < TN; ++jj) bb[jj] = __ldg(bias + ff_col<TN>(jj, c));
  bar_sync(1, kFfConsumers);  // every consumer has read the tile
  post();
  // ---- epilogue ----
#pragma unroll
  for (int jj = 0; jj < TN; ++jj) {
    float* dst = act + ff_col<TN>(jj, c) * kFfLd + 4 * g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[4 * h + e][jj] + bb[jj];
        if (RELU) v[e] = fmaxf(v[e], 0.f);
      }
      *reinterpret_cast<float4*>(dst + 32 * h) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // ---- end of the epilogue ----
  bar_sync(1, kFfConsumers);  // the tile holds this product's output
}

// The walk. TW = width / 32, TH = view width / 32; L the streams' layout:
// the inputs [3, n] or [n, 3], the raw heads [4, n] or [n, 4].
template <typename Enc, int TW, int TH, typename L>
__global__ void __launch_bounds__(kFfThreads, 1)
    fwd_f32_kernel(const float* __restrict__ pts,
                   const float* __restrict__ covs,
                   const float* __restrict__ views,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float* __restrict__ out, int n, Dims d, FhPlan pl) {
  extern __shared__ __align__(16) unsigned char ff_raw[];
  const FfSmem so(d, pl.stages, pl.npe);
  const int stages = pl.stages, npe = pl.npe, tiles = pl.tiles;
  const int W = d.width, H = d.half, P = d.P, V = d.V;
  const int slot_floats = kFfSlab * (W > H ? W : H);
  float* ring = reinterpret_cast<float*>(ff_raw + so.ring);
  float* act = reinterpret_cast<float*>(ff_raw + so.act);
  float* pe = reinterpret_cast<float*>(ff_raw + so.pe);
  float* ve = reinterpret_cast<float*>(ff_raw + so.ve);
  float* wa_s = reinterpret_cast<float*>(ff_raw + so.wa);
  float* wr_s = reinterpret_cast<float*>(ff_raw + so.wr);
  uint64_t* full = reinterpret_cast<uint64_t*>(ff_raw + so.bars);
  uint64_t* empty = full + stages;
  uint64_t* pe_full = empty + stages;
  uint64_t* pe_empty = pe_full + 2;
  uint64_t* ve_full = pe_empty + 2;
  uint64_t* ve_empty = ve_full + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFfConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&pe_full[s], kFhEncoders);
      mbar_init(&pe_empty[s], 1);
    }
    mbar_init(ve_full, kFhEncoders);
    mbar_init(ve_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // pe and ve (contiguous) start zero: their padding columns are never
  // written again.
  for (int e = threadIdx.x; e < (npe * P + V) * kFfLd; e += kFfThreads)
    pe[e] = 0.f;
  for (int c = threadIdx.x; c < W; c += kFfThreads) wa_s[c] = w[d.w_alpha() + c];
  for (int c = threadIdx.x; c < 3 * H; c += kFfThreads)
    wr_s[c] = w[d.w_rgb() + c];
  __syncthreads();

  if (threadIdx.x >= kFfConsumers) {
    // ------------------------------ producer ------------------------------
    if (threadIdx.x == kFfConsumers) {  // the weight stream
      int issued = 0;
      for (int k = 0; (int)blockIdx.x + k * (int)gridDim.x < tiles; ++k) {
        for (int q = 0; q < d.depth + 2; ++q) {
          const int N = q <= d.depth ? W : H;
          const int rows = q < d.depth ? d.rows(q) : q == d.depth ? W : W + V;
          const float* src = w + (q < d.depth    ? d.w_layer(q)
                                  : q == d.depth ? d.w_feature()
                                                 : d.w_views());
          const uint32_t bytes = (uint32_t)(kFfSlab * N * 4);
          for (int r0 = 0; r0 < rows; r0 += kFfSlab, ++issued) {
            const int slot = issued % stages;
            if (issued >= stages)
              mbar_wait(&empty[slot], (issued / stages - 1) & 1);
            mbar_expect_tx(&full[slot], bytes);
            bulk_load(ring + slot * slot_floats, src + (size_t)r0 * N, bytes,
                      &full[slot]);
          }
        }
      }
    } else if (threadIdx.x >= 288) {  // the encoders
      for (int k = 0, tile; (tile = blockIdx.x + k * gridDim.x) < tiles;
           ++k) {
        const int base = tile * kFfTile, valid = min(kFfTile, n - base);
        const int pb = k % npe;
        if (k >= npe) mbar_wait(&pe_empty[pb], (k / npe - 1) & 1);
        FhEnc<Enc>::template points<L, kFfTile>(
            pts, covs, n, base, valid, d, FfStore{pe + pb * P * kFfLd});
        mbar_arrive(&pe_full[pb]);
        if (k >= 1) mbar_wait(ve_empty, (k - 1) & 1);
        FhEnc<Enc>::template views<L, kFfTile>(views, n, base, valid, d,
                                               FfStore{ve});
        mbar_arrive(ve_full);
      }
    }
    return;
  }

  // ------------------------------ consumers -------------------------------
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (warp % 4) * 8 + lane / 4;  // column group
  const int g = (warp / 4) * 4 + lane % 4;  // row group
  FfRing r{ring, slot_floats, stages, 0, full, empty};
  int last_pe = 0;  // the last product that reads pe
  for (int q = 1; q < d.depth; ++q)
    if (d.skip_before(q)) last_pe = q;
  const float ba = b[d.b_alpha()];
  const float* br = b + d.b_rgb();
  // The heads, fwd_tile's dots: alpha over h in column order, one thread a
  // point; rgb over the view layer's output, one thread a point and
  // channel.
  auto alpha = [&](int base, int valid) {
    // ---- alpha head ----
    const int p = threadIdx.x;
    if (p < valid && p < kFfTile) {
      float s = 0.f;
      for (int cc = 0; cc < W; ++cc) s = fmaf(act[cc * kFfLd + p], wa_s[cc], s);
      out[L::at(3, (size_t)base + p, n, 4)] = s + ba;
    }
    // ---- end of the alpha head ----
  };
  auto rgb = [&](int base, int valid) {
    // ---- rgb head ----
    const int p = threadIdx.x % kFfTile, ch = threadIdx.x / kFfTile;
    if (ch < 3 && p < valid) {
      float s = 0.f;
      for (int kk = 0; kk < H; ++kk)
        s = fmaf(act[kk * kFfLd + p], wr_s[ch * H + kk], s);
      out[L::at(ch, (size_t)base + p, n, 4)] = s + br[ch];
    }
    // ---- end of the rgb head ----
  };
  int k = 0, base_prev = 0, valid_prev = 0;
  for (int tile; (tile = blockIdx.x + k * gridDim.x) < tiles; ++k) {
    const int base = tile * kFfTile, valid = min(kFfTile, n - base);
    const int pb = k % npe;
    const float* pe_b = pe + pb * P * kFfLd;
    mbar_wait(&pe_full[pb], (k / npe) & 1);
    for (int q = 0; q < d.depth; ++q) {
      const bool pe_in = q == 0 || d.skip_before(q);
      ff_layer<TW, true>(
          pe_in ? pe_b : act, pe_in ? P : W, act, q > 0 && pe_in ? W : 0,
          b + d.b_layer(q), act, r, c, g,
          [&] {
            if (q == 0 && k > 0) rgb(base_prev, valid_prev);
          },
          [&] {
            if (q == last_pe && threadIdx.x == 0) mbar_arrive(&pe_empty[pb]);
          });
    }
    // The feature layer reads h: the alpha head reads it meanwhile.
    ff_layer<TW, false>(
        act, W, nullptr, 0, b + d.b_feature(), act, r, c, g,
        [&] { alpha(base, valid); }, [] {});
    mbar_wait(ve_full, k & 1);
    ff_layer<TH, true>(act, W, ve, V, b + d.b_views(), act, r, c, g, [] {},
                       [&] {
                         if (threadIdx.x == 0) mbar_arrive(ve_empty);
                       });
    base_prev = base;
    valid_prev = valid;
  }
  if (k > 0) rgb(base_prev, valid_prev);
}

// The plan of this walk at these shapes (`instance`: the source holds the
// kernel for (width / 32, view width / 32)): widths that are multiples of
// 64 up to 256, a view layer up to 256 wide in steps of 32, P up to 128 and
// V up to 64 columns, heads on h alone with the view branch (not v1's
// shapes past #1's), and a shared memory that holds two pe buffers and a
// ring of 4 to 2 slots, else one pe buffer. ok = 2 where it runs, else 0
// (fwd_tile). Returns a cudaError_t.
inline int ff_plan(const Dims& d, int n, bool instance, FhPlan* pl) {
  *pl = FhPlan{};
  pl->tiles = (n + kFfTile - 1) / kFfTile;
  pl->gt = 1;
  if (!(instance && d.width % 64 == 0 && d.width <= 256 &&
        d.half % 32 == 0 && d.half <= 256 && d.P <= 128 && d.V <= 64 &&
        d.depth >= 1 && !d.head_skip() && d.out_ch == 0))
    return 0;
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  for (pl->npe = 2; pl->npe >= 1; --pl->npe) {
    for (pl->stages = kFfMaxStages; pl->stages >= 2; --pl->stages) {
      pl->smem = FfSmem(d, pl->stages, pl->npe).total;
      if (pl->smem <= smem_max) break;
    }
    if (pl->stages >= 2) break;
  }
  if (pl->npe == 0) return 0;  // nothing fits: fwd_tile
  pl->ok = 2;
  pl->grid = pl->tiles < sms ? pl->tiles : sms;
  return 0;
}

template <typename Enc, int TW, int TH, typename L>
int ff_launch(const FhPlan& pl, const void* pts, const void* covs,
              const void* views, const void* w, const void* b, void* out,
              int n, const Dims& d, cudaStream_t stream) {
  // The slabs are bulk copies: a 16-byte aligned base (every slab's
  // offset, 16 rows of 4 N bytes, is a multiple of 16).
  if (reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorMisalignedAddress;
  auto kernel = fwd_f32_kernel<Enc, TW, TH, L>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<pl.grid, kFfThreads, pl.smem, stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(covs),
      static_cast<const float*>(views), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), n, d, pl);
  return (int)cudaGetLastError();
}

// The instances of this walk: the NeRFMLP's (width / 32, width / 64) and
// the MipMLP's (width / 32, 4: its 128-wide view layer) at widths 64, 128,
// 192, 256.
inline bool ff_nerf_instance(const Dims& d) {
  return d.width % 64 == 0 && d.width >= 64 && d.width <= 256 &&
         2 * d.half == d.width;
}

inline bool ff_mip_instance(const Dims& d) {
  return d.width % 64 == 0 && d.width >= 64 && d.width <= 256 &&
         d.half == 128;
}

template <typename Enc, int TH0, typename L>
int ff_dispatch(const FhPlan& pl, const void* pts, const void* covs,
                const void* views, const void* w, const void* b, void* out,
                int n, const Dims& d, cudaStream_t s) {
  // TH0 > 0: the view width / 32 of every instance; 0: width / 64.
  switch (d.width / 64) {
    case 1:
      return ff_launch<Enc, 2, TH0 ? TH0 : 1, L>(pl, pts, covs, views, w, b,
                                                 out, n, d, s);
    case 2:
      return ff_launch<Enc, 4, TH0 ? TH0 : 2, L>(pl, pts, covs, views, w, b,
                                                 out, n, d, s);
    case 3:
      return ff_launch<Enc, 6, TH0 ? TH0 : 3, L>(pl, pts, covs, views, w, b,
                                                 out, n, d, s);
    default:
      return ff_launch<Enc, 8, TH0 ? TH0 : 4, L>(pl, pts, covs, views, w, b,
                                                 out, n, d, s);
  }
}

// ---------------------------------------------------------------------------
// The forwards' dispatch: three walks, decided by shapes alone
// ---------------------------------------------------------------------------

// The walk of a forward (#1, #6, #10, #12 / #13, #15) at these shapes, the
// same for both layouts: in bf16 fwd_hopper.cuh's walk (ok = 1) where
// fh_plan takes it, in fp32 this walk (ok = 2) where ff_plan takes it,
// else fwd_tile (ok = 0). Returns a cudaError_t.
inline int fwd_walk_plan(const Dims& d, int n, bool bf16_, bool bf16_instance,
                         bool f32_instance, FhPlan* pl) {
  return bf16_ ? fh_plan(d, n, true, bf16_instance, pl)
               : ff_plan(d, n, f32_instance, pl);
}

// The plan in the plan functions' slots: out[0..7] = the walk (0 fwd_tile,
// 1 the bf16 walk, 2 this walk), points a tile, ring slots, cluster size,
// shared memory bytes, blocks, pe buffers, tiles.
inline void fwd_plan_slots(const FhPlan& pl, const Dims& d, int n, bool bf16_,
                           long long* out) {
  out[0] = pl.ok;
  out[1] = pl.ok == 1 ? kFhTile : pl.ok == 2 ? kFfTile : (bf16_ ? 128 : 64);
  out[2] = pl.ok ? pl.stages : 0;
  out[3] = 1;
  out[4] = pl.ok ? pl.smem
                 : (long long)(bf16_ ? fwd_smem_bytes<bf16, 128>(d)
                                     : fwd_smem_bytes<float, 64>(d));
  out[5] = pl.ok ? pl.grid : (n + out[1] - 1) / out[1];
  out[6] = pl.ok ? pl.npe : 0;
  out[7] = (n + out[1] - 1) / out[1];
}

// The NeRFMLP forward of #1 (ColMajor), #10 (RowMajor) and #12 / #13
// (RowMajor, V1: v1's head shapes where fwd_tile runs): the walk of
// fwd_walk_plan. A failed launch of a walk returns its error; nothing falls
// back to another walk. Returns a cudaError_t.
template <typename L, bool V1 = false>
int fh_nerf_forward(const void* pts, const void* views, const void* w,
                    const void* b, void* out, int n, const Dims& d,
                    bool bf16_, cudaStream_t s) {
  FhPlan pl;
  const int err = fwd_walk_plan(d, n, bf16_, fh_nerf_instance(d),
                                ff_nerf_instance(d), &pl);
  if (err) return err;
  if (pl.ok == 1)
    return fh_nerf_launch<kFhHeads, L>(pl, pts, views, w, b, out, n, d, s);
  if (pl.ok == 2)
    return ff_dispatch<NerfEnc, 0, L>(pl, pts, nullptr, views, w, b, out, n,
                                      d, s);
  if (bf16_)
    return fwd_launch<bf16, 128, NerfEnc, L, V1>(pts, nullptr, views, w, b,
                                                 out, n, d, s);
  return fwd_launch<float, 64, NerfEnc, L, V1>(pts, nullptr, views, w, b,
                                               out, n, d, s);
}

// fh_nerf_forward's plan at these shapes, the same for both layouts:
// out[0..7] as fwd_plan_slots. Returns a cudaError_t.
inline int fh_nerf_plan(const Dims& d, int n, bool bf16_, long long* out) {
  FhPlan pl;
  const int err = fwd_walk_plan(d, n, bf16_, fh_nerf_instance(d),
                                ff_nerf_instance(d), &pl);
  if (err) return err;
  fwd_plan_slots(pl, d, n, bf16_, out);
  return 0;
}

}  // namespace mlp
