// The bf16 forward walk of kernels #1 (fused_mlp_fwd.cu, the NeRFMLP)
// and #6 (fused_mip_fwd.cu, the MipMLP) for Hopper, and of the two kernels
// that add a tail after the heads: 6n (fused_mip_fwd.cu, the normals: a
// walk back through the trunk, see "6n" below) and #4 (render_level.cu,
// the compositing of whole rays, see "#4" below); and of the row-major
// twins #10 (fused_mlp_fwd_row) and the v1 forward #12 / #13
// (fused_mlp_v1_fwd.cu), which compute #1's function, and #15
// (fused_mip_fwd_row), which computes #6's, on row-major [N, 3] streams
// into [N, 4] at the shapes this walk takes. The kernel is templated on
// the stream layout (mlp_common.cuh::ColMajor / RowMajor): the encoders
// read the points and views through L::at, and the heads store with a
// channel stride and a row stride ((n, 1) transposed, (1, 4) row-major,
// (gp, 1) into #4's group buffer). fp32 #1 / #6 / #10 / #12 / #13 / #15
// run fwd_f32.cuh's walk (which shares this file's encoders, FhEnc); the
// widths neither walk takes and the v1 shapes past #1's (a skip into the
// heads, the output head, P > 128) keep mlp_fwd.cuh::fwd_tile, and in fp32
// 6n keeps mlp_train.cuh's mode 5 and #4 fwd_tile and composite_ray.
// The plan functions of the sources (fused_mlp_fwd_plan,
// fused_mlp_v1_fwd_plan, fused_mip_fwd_plan through fwd_f32.cuh::
// fwd_walk_plan; fused_mip_fwd_normals_plan, render_level_plan from
// fh_plan here) decide by shapes alone which walk runs.
//
// What it replaces: fwd_tile ran one 128-point tile per block (8 warps,
// one block an SM). Every warp loaded each 16-deep weight fragment from
// L2 with legacy wmma and waited on it, staged every 16x16 accumulator
// through shared memory for the epilogue, and computed the heads as
// serial dot products while the tensor cores idled: ~196 us a tile at the
// flagship fine render chunk against the ~20 us its FLOP take (H100).
//
// Bound: operations (1.19-1.22 MFLOP against 40-52 bytes a point, see
// mlp_fwd.cuh). What the design does about it:
//   * Persistent blocks, one an SM: block b walks tiles b, b + grid, ...
//     of 128 points, so the next tile's encoding and weight slabs overlap
//     the current tile's products.
//   * Three warpgroups. Two consumers each own 64 of the tile's points
//     over the whole N of every product: wgmma m64nNk16 with N the layer's
//     width (up to 256, 128 fp32 accumulators a thread), both operands
//     from shared memory, so each 64 x N weight slab feeds 128 points. The
//     producer warpgroup gives up registers (setmaxnreg 40; the consumers
//     take 232): its warp 0 keeps the weight slabs in flight, one thread
//     issuing TMA loads into a ring of `stages` slots under full / empty
//     mbarriers in the fixed order of the products (trunk layers,
//     feature, views, tile after tile); its warps 1-3 encode the next
//     tile's PE / IPE into a second pe buffer and its view encoding into
//     the ve buffer, handed over by mbarriers. Where shared memory is short
//     (the mip's 96-column IPE at width 256) the ring has 2 slots rather
//     than 3: the encoding is the costlier wait there. The encoders work a
//     pair of features at a time (sin and cos share the argument and, in
//     the IPE, the damping) and reduce the mip's sine arguments by an
//     exact fma remainder (fh_safe_sin) in place of fmodf.
//   * A from shared memory by descriptor: every activation buffer is kept
//     in the canonical K-major 128-byte swizzled layout (64-column panels
//     of 128 rows x 128 bytes), which the epilogue writes directly from
//     the accumulators (bias, ReLU, the bf16 round) over the consumer's
//     own 64 rows, in place, after wgmma.wait_group 0. No block-wide
//     barrier sits between layers: a named barrier a warpgroup, and the
//     ring's. The skip layer reads [pe | h] and the view layer [feature |
//     ve], one descriptor per 16-deep step; steps past the reduction (the
//     slab's rows there belong to the next layer) read zero columns, the
//     never-written tail of ve or pe.
//   * The epilogue reads the biases from shared memory, rounds with
//     cvt.relu and stores four 8 x 8 blocks a stmatrix.
//   * The heads (alpha W -> 1 from the last trunk layer, before the
//     feature layer overwrites it; rgb H -> 3 from the view layer) read
//     the rounded activations from the tile in column order, one thread a
//     row (and channel), with the head weights in shared memory, while a
//     product's first slab multiplies: alpha during the feature layer's,
//     rgb during the next tile's layer 0 (which reads pe only).
//
// Rounding is fwd_tile's (mlp_fwd.cuh): the encodings in fp32 with the
// same values (FhEnc), then cast; bf16 operands with fp32 accumulation
// in the same k order; fp32 biases; trunk ReLU then bf16; `feature` to
// bf16 without ReLU; alpha and rgb in fp32 from the bf16 activations,
// summed in column order as fwd_tile sums them. So the walk gives
// fwd_tile's bits (the wgmma products give the wmma products' bits, as in
// level_train.cuh). The row-major layout changes where a value is read and
// stored, not its value or the order of any sum: #10 and #12 / #13 give
// #1's bits on the same points, and #15 #6's. No cross-block reduction:
// two launches give the same bits.
//
// 6n (kFhNormals): d(raw density)/d(means) after #6's walk, whose rows
// 0-3 it gives bit for bit. The JAX function (fused_mip.py::
// _mip_density_dmeans) reads the forward's activations only as `act > 0`,
// so the walk keeps each trunk layer's ReLU mask, one bit a unit, and no
// activation. A consumer thread's accumulator positions are the same in a
// layer's forward product and in the backward product that gives the
// gradient by that layer's output (m64, N = width, the same 64 rows), so
// each thread keeps the bits of its own positions in registers: width / 64
// words a layer, a stack of at most kFhMaskDepth layers (the plan sends
// deeper trunks to mode 5). After the heads (the rgb head then, not during
// the next tile: the walk back overwrites hv), the walk back starts from
// g = the density head's weights: per layer from the top, g masked and
// rounded to bf16 into the tile (the epilogue's stmatrix, the mask in
// place of bias and ReLU), then g W^T on wgmma with B the same 64 x 64
// weight boxes read K-major (the weight stream carries the trunk's slabs
// again, in reverse, after the tile's forward slabs): the pe rows' product
// (layer 0 and the post-skip layer, N = 96 at 16 frequencies) accumulates
// the encoding's gradient in fp32 registers over both layers, the h rows'
// product gives the next g. No workspace and no save to device memory. At
// the end the encoding's gradient goes to the tile in fp32, and per point
// and coordinate the IPE's Jacobian (mode 5's arithmetic: damp cos(y),
// damp cos(y + pi/2), times 2^k, summed over k) reads the means and covs
// again (24 bytes a point). Rounding is the JAX function's: g rounded to
// bf16 before each product, fp32 accumulation, the encoding's gradient in
// fp32.
//
// #4 (kFhRender): the render's level, the raw heads composited over whole
// rays without leaving the block. A block walks groups of gp = lcm(S, 128)
// points (whole rays: the fine level's 384 points are 3 tiles and 2 rays
// of 192, the coarse level's 128 one tile and 2 rays of 64): groups b,
// b + grid, ... The heads go to the group's buffer in shared memory
// ([4, gp] fp32) instead of device memory. A group's last rgb head is
// computed during the next group's first product (as above), so after it
// the consumers hand the buffer to the encoder warps (heads_full), which
// composite each ray with one warp (fh_composite_ray) and write the six
// rows while the consumers run the next group's trunk; the consumers wait
// for the buffer (heads_empty) before that group's first alpha head. The
// heads are #1's bits on the same points; the plan refuses an S whose
// group's buffer does not fit beside the walk (render_level.cu keeps the
// old kernel there).

#pragma once

#include "hopper.cuh"
#include "mlp_fwd.cuh"

namespace mlp {

constexpr int kFhTile = 128;             // points a tile, 64 a consumer
constexpr int kFhThreads = 384;          // consumers 0-255, producer 256-383
constexpr int kFhPanel = kFhTile * 128;  // a 64-column panel of a tile
constexpr int kFhBox = 8192;             // a weight box: 64 x 64 bf16
constexpr int kFhEncoders = 96;          // producer warps 1-3
constexpr int kFhMaxProds = 20;          // products a tile: depth + 2
constexpr int kFhMaskDepth = 8;          // 6n: trunk layers of masks

// The work after the heads: none (#1, #6: the raw heads to device memory),
// 6n's walk back through the trunk, #4's compositing.
constexpr int kFhHeads = 0, kFhNormals = 1, kFhRender = 2;

// #4's per-ray inputs (null in the other kernels).
struct FhRays {
  const float* z;   // [n] each sample's depth, ray-major
  const float* dn;  // [n_rays] |d| of each ray
  int n_rays, seg, white;
};

// The launch plan: whether this walk runs, and its shape.
struct FhPlan {
  int ok;      // 1: this walk; 0: fwd_tile
  int stages;  // weight ring slots
  int npe;     // pe buffers (2: the next tile's PE overlaps the skip layer)
  int pp;      // 64-column panels of pe
  int na;      // panels of the activation tile and boxes a ring slot
  int smem;    // dynamic shared memory, bytes
  int grid;    // blocks: min(SMs, groups)
  int tiles;   // 128-point tiles
  int gp;      // #4: points a group (whole rays); 0 elsewhere
  int gt;      // tiles a group (#4: gp / 128; 1 elsewhere)
};

// One product of a tile: its first row in its weight map (map 0: trunk
// and feature, map 1: the view layer; hopper.cuh::weight_maps) and its
// 16-deep reduction steps.
struct FhProd {
  int row0, map, ks;
};

__host__ __device__ inline FhProd fh_prod(const Dims& d, int q) {
  const int W = d.width;
  if (q < d.depth) return FhProd{(int)(d.w_layer(q) / W), 0, d.rows(q) / 16};
  if (q == d.depth) return FhProd{(int)(d.w_feature() / W), 0, W / 16};
  return FhProd{0, 1, (W + d.V) / 16};
}

// The most reduction steps past a product's end in its last 64-row slab.
__host__ __device__ inline int fh_max_past(const Dims& d) {
  int m = 0;
  for (int q = 0; q < d.depth + 2; ++q) {
    const int past = (4 - fh_prod(d, q).ks % 4) % 4;
    m = past > m ? past : m;
  }
  return m;
}

// Where the steps past a reduction read their zero columns: 1 the tail of
// ve (columns V..63), 0 the tail of pe (P..64 pp - 1), -1 nowhere.
__host__ __device__ inline int fh_zero_src(const Dims& d, int pp) {
  const int need = 16 * fh_max_past(d);
  if (64 - d.V >= need) return 1;
  if (64 * pp - d.P >= need) return 0;
  return -1;
}

// The products' biases as the epilogues read them from shared memory: the
// trunk layers' and feature's (as packed), then the view layer's, zero
// past its width up to its last 64-column block.
__host__ __device__ inline int fh_bias_floats(const Dims& d) {
  return d.b_views() + (d.half + 63) / 64 * 64;
}

// Byte offsets of the shared-memory regions from the 1024-aligned base
// (gp: #4's group points, 0 elsewhere).
struct FhSmem {
  int ring, act, pe, ve, bias, wa, wr, bars, prods, heads, hbars, total;
  __host__ __device__ FhSmem(const Dims& d, int stages, int npe, int pp,
                             int na, int gp = 0) {
    int o = 0;
    ring = o; o += stages * na * kFhBox;
    act = o; o += na * kFhPanel;
    pe = o; o += npe * pp * kFhPanel;
    ve = o; o += kFhPanel;
    bias = o; o += 4 * fh_bias_floats(d);
    wa = o; o += (2 * d.width + 15) / 16 * 16;
    wr = o; o += (6 * d.half + 15) / 16 * 16;
    bars = o; o += (2 * stages + 6) * 8;
    prods = o; o += kFhMaxProds * (int)sizeof(FhProd);
    heads = o; o += 16 * gp;      // #4: the group's raw heads [4, gp] fp32
    hbars = o; o += gp ? 16 : 0;  // #4: heads_full, heads_empty
    total = o + 1024;  // the base's alignment
  }
};

// Byte offset of column c in a 128B-swizzled K-major buffer of 128-row
// panels, from its row 0 (add 128 r and swizzle for row r: fh_elem).
__device__ inline uint32_t fh_col(int c) {
  return (uint32_t)((c >> 6) * kFhPanel + (c & 63) * 2);
}

// Byte offset of element (r, c) of such a buffer.
__device__ inline int fh_elem(int r, int c) {
  return (c >> 6) * kFhPanel + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// One 16-deep step of a product of width N: wgmma_ss (N = 64 NB) or
// wgmma_ss96; TB as there.
template <int N, int TB, int NACC>
__device__ inline void fh_mma(float (&acc)[NACC], uint64_t da, uint64_t db,
                              int scale_d) {
  if constexpr (N == 96)
    wgmma_ss96<NACC, TB>(acc, da, db, scale_d);
  else
    wgmma_ss<N / 64, NACC, TB>(acc, da, db, scale_d);
}

// The next product of the weight stream for this consumer's 64 rows: A is
// [s0 (k0 steps) | s1 (k1 steps)] then zero columns (az), each a shared
// address of the source's column 0 at this warpgroup's first row. acc's
// first N / 2 floats get the result, or add it (accum). A slab of the
// forward (TB = 1) is 64 rows of K by N columns (MN-major); of the walk
// back (TB = 0, 6n) 64 of the layer's columns (the reduction) by N of its
// rows (K-major). Slab j of the product is released (one arrival of this
// warpgroup on its empty barrier) once its MMAs are done; t counts the
// slabs consumed. hook() runs while the first slab's MMAs do (a head, on
// registers other than acc).
template <int N, int TB, int NA, int NACC, typename Hook>
__device__ inline void fh_product_n(float (&acc)[NACC], uint32_t ring,
                                    uint64_t* full, uint64_t* empty,
                                    int stages, int& t, uint32_t a0, int k0,
                                    uint32_t a1, int k1, uint32_t az,
                                    bool accum, Hook hook) {
  const int ks = k0 + k1, nslab = (ks + 3) / 4;
  const bool lead = threadIdx.x % 128 == 0;
  for (int j = 0; j < nslab; ++j) {
    const int u = t + j, slot = u % stages;
    mbar_wait(&full[slot], (u / stages) & 1);
    const uint32_t sb = ring + slot * NA * kFhBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int s = 4 * j + kk;
      const uint32_t a = s < k0   ? a0 + fh_col(16 * s)
                         : s < ks ? a1 + fh_col(16 * (s - k0))
                                  : az + 32 * (s - ks);
      fh_mma<N, TB>(acc, sw128_desc(a),
                    TB ? sw128_desc_mn(sb + kk * 2048, kFhBox)
                       : sw128_desc(sb + kk * 32),
                    s > 0 || accum);
    }
    wgmma_commit();
    if (j == 0) hook();
    if (j > 0) {
      wgmma_wait<1>();
      if (lead) mbar_arrive(&empty[(u - 1) % stages]);
    }
  }
  wgmma_wait<0>();
  if (lead) mbar_arrive(&empty[(t + nslab - 1) % stages]);
  t += nslab;
}

// A forward product (N = 64 NB, the result in acc's first 32 NB floats).
template <int NB, int NA, typename Hook>
__device__ inline void fh_product(float (&acc)[32 * NA], uint32_t ring,
                                  uint64_t* full, uint64_t* empty,
                                  int stages, int& t, uint32_t a0, int k0,
                                  uint32_t a1, int k1, uint32_t az,
                                  Hook hook) {
  fh_product_n<64 * NB, 1, NA>(acc, ring, full, empty, stages, t, a0, k0,
                               a1, k1, az, false, hook);
}

// The epilogue of a product, on its accumulators: v = acc + bias (bias:
// shared memory, zero past the layer's width), ReLU where RELU, rounded to
// bf16 into this warpgroup's 64 rows of the tile (rows: its row 0), in
// place, four 8 x 8 blocks a stmatrix: columns 8 n8 .. 8 n8 + 15, rows
// 16 w .. 16 w + 15 of warp w. MASK (6n): also sets bit a % 32 of mk[a /
// 32] where the rounded value of accumulator a is > 0 (bf16 bits in 1 ..
// 0x7f80: not 0, not NaN), the JAX function's `act > 0`.
template <int NB, int NA, bool RELU, bool MASK = false>
__device__ inline void fh_epilogue(const float (&acc)[32 * NA],
                                   const float* bias, unsigned char* rows,
                                   uint32_t* mk = nullptr) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  // This lane's row address: matrix lane / 8 is (rows + 8 (lane / 8 % 2),
  // column block n8 + lane / 16).
  unsigned char* ra = rows + (16 * w + 8 * (lane / 8 % 2) + lane % 8) * 128;
  const float* bl = bias + 2 * (lane % 4);
#pragma unroll
  for (int n8 = 0; n8 < 8 * NB; n8 += 2) {
    // ---- epilogue ----
    uint32_t r[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float2 bb = *reinterpret_cast<const float2*>(bl + 8 * (n8 + m));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        r[2 * m + h] = pack_bf16x2<RELU>(acc[4 * (n8 + m) + 2 * h] + bb.x,
                                         acc[4 * (n8 + m) + 2 * h + 1] + bb.y);
        if constexpr (MASK) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t v = (r[2 * m + h] >> (16 * e)) & 0xffffu;
            mk[(n8 + m) / 8] |= (uint32_t)(v - 1u < 0x7f80u)
                                << (4 * ((n8 + m) % 8) + 2 * h + e);
          }
        }
      }
    }
    const int cb = n8 + lane / 16;
    stmatrix_x4(ra + (cb / 8) * kFhPanel + (((cb % 8) ^ (lane % 8)) << 4), r);
    // ---- end of the epilogue ----
  }
}

// 6n's epilogue of the walk back: g = acc (FIRST: the density head's
// weights wd, the same for every point) where this thread's mask bits mk
// (as fh_epilogue<MASK> set them for the layer) are set, else 0, rounded
// to bf16 (no bias, no ReLU) into this warpgroup's rows, stored as
// fh_epilogue stores.
template <int NB, int NA, bool FIRST>
__device__ inline void fh_grad_epilogue(const float (&acc)[32 * NA],
                                        const bf16* wd, const uint32_t* mk,
                                        unsigned char* rows) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  unsigned char* ra = rows + (16 * w + 8 * (lane / 8 % 2) + lane % 8) * 128;
  const bf16* wl = wd + 2 * (lane % 4);
#pragma unroll
  for (int n8 = 0; n8 < 8 * NB; n8 += 2) {
    uint32_t r[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float2 wv = make_float2(0.f, 0.f);
      if constexpr (FIRST)
        wv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(wl + 8 * (n8 + m)));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 4 * (n8 + m) + 2 * h;
        const uint32_t bits = mk[a / 32] >> (a % 32);
        const float lo = FIRST ? wv.x : acc[a], hi = FIRST ? wv.y : acc[a + 1];
        r[2 * m + h] = pack_bf16x2<false>((bits & 1u) ? lo : 0.f,
                                          (bits & 2u) ? hi : 0.f);
      }
    }
    const int cb = n8 + lane / 16;
    stmatrix_x4(ra + (cb / 8) * kFhPanel + (((cb % 8) ^ (lane % 8)) << 4), r);
  }
}

// 6n's stack of masks, a layer's NB words at mk[0 .. NB - 1]: push moves
// the layers below up and zeroes the top; pop drops the top.
template <int NB, int MW>
__device__ inline void fh_mask_push(uint32_t (&mk)[MW]) {
#pragma unroll
  for (int k = MW - 1; k >= NB; --k) mk[k] = mk[k - NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) mk[k] = 0u;
}

template <int NB, int MW>
__device__ inline void fh_mask_pop(uint32_t (&mk)[MW]) {
#pragma unroll
  for (int k = 0; k + NB < MW; ++k) mk[k] = mk[k + NB];
}

// #4's compositing of one ray of S samples by one warp: the function of
// mlp_common.cuh::composite_ray (relu density, alpha = 1 - exp(-sigma
// dist) with the last distance 1e10, both scaled by |d|; v = max(1 -
// alpha, 1e-10); white background; depth sum(w z)) on the ray's raw heads
// in shared memory (row k at raw + k ld), writing its six rows of out
// ([6, np] from point pt0). The samples go 32 at a time, one a lane. The
// transmittance before sample i is carry * (the product of v over the
// lanes below i in its round: a Hillis-Steele scan, five shfl_up steps),
// carry being the product of the earlier rounds' v, so its fp32 products
// associate otherwise than composite_ray's serial T *= v (a few ulp).
// The sums over the samples are lane sums, then an xor butterfly.
__device__ inline void fh_composite_ray(const float* raw, int ld,
                                        const float* z, float dn, int S,
                                        bool white, float* out, size_t np,
                                        size_t pt0) {
  const int lane = threadIdx.x % 32;
  float carry = 1.f, acc = 0.f, dep = 0.f, c[3] = {0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < S; i0 += 32) {
    const int i = i0 + lane;
    float alpha = 0.f, v = 1.f, zi = 0.f;
    if (i < S) {
      zi = z[i];
      const float dist = (i == S - 1 ? 1e10f : z[i + 1] - zi) * dn;
      alpha = 1.f - expf(-fmaxf(raw[3 * ld + i], 0.f) * dist);
      v = fmaxf(1.f - alpha, 1e-10f);
    }
    float p = v;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float q = __shfl_up_sync(0xffffffffu, p, o);
      if (lane >= o) p *= q;
    }
    float ex = __shfl_up_sync(0xffffffffu, p, 1);
    if (lane == 0) ex = 1.f;
    const float w = alpha * (carry * ex);
    carry *= __shfl_sync(0xffffffffu, p, 31);
    if (i < S) {
      acc += w;
      dep += w * zi;
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] += w / (1.f + expf(-raw[k * ld + i]));
      out[5 * np + pt0 + i] = w;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
    dep += __shfl_xor_sync(0xffffffffu, dep, o);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] += __shfl_xor_sync(0xffffffffu, c[k], o);
  }
  if (white)
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] += 1.f - acc;
  for (int i = lane; i < S; i += 32) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k * np + pt0 + i] = c[k];
    out[3 * np + pt0 + i] = dep;
    out[4 * np + pt0 + i] = acc;
  }
}

// fp32 dot of row r's first k bf16 activations (rows: row 0 of the
// buffer) with wv, in column order (fwd_tile's head_dot order).
__device__ inline float fh_row_dot(const unsigned char* rows, int r,
                                   const bf16* wv, int k) {
  float s = 0.f;
  for (int c0 = 0; c0 < k; c0 += 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(rows + fh_elem(r, c0));
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(to_f(h[e]), to_f(wv[c0 + e]), s);
  }
  return s;
}

// core/mathx.py::safe_sin as mlp_common.cuh::safe_sin computes it, with
// the same bits: where |y| >= 100 pi, fmodf's exact truncated remainder
// y - q t (t = 100 pi in fp32) comes from one fma with the integer quotient
// q, which is exact because the remainder is representable; q from the
// rounded y / t is off by at most one, which the remainder's sign and size
// show. Then the floored step and sinf, as safe_sin.
__device__ inline float fh_safe_sin(float y) {
  if (!(fabsf(y) < kTrigRange)) {
    float q = truncf(y * (1.f / kTrigRange));
    float r = fmaf(-q, kTrigRange, y);
    if (y > 0.f ? r < 0.f : r > 0.f) {
      q -= copysignf(1.f, y);
      r = fmaf(-q, kTrigRange, y);
    } else if (fabsf(r) >= kTrigRange) {
      q += copysignf(1.f, y);
      r = fmaf(-q, kTrigRange, y);
    }
    if (r == 0.f) r = copysignf(0.f, y);  // fmodf's zero has y's sign
    if (r != 0.f && r < 0.f) r += kTrigRange;
    y = r;
  }
  return sinf(y);
}

// The producer's encoders (threads 288-383): a tile's point features into
// pe and its view features into ve, every point of the tile (zeros past
// `valid`), rounded to bf16 at fh_elem. The padding columns stay as the
// kernel's start zeroed them. Coordinate r of point p is read at L::at(r,
// p, n, 3): a row-major stream's tile is 3 x 128 contiguous floats, read
// 12 bytes apart by neighbouring threads; the encoders run off the
// consumers' path, so the reads are direct rather than staged.
__device__ inline void fh_store(unsigned char* buf, int p, int c, float v) {
  *reinterpret_cast<bf16*>(buf + fh_elem(p, c)) = __float2bfloat16_rn(v);
}

template <typename Enc>
struct FhEnc;

// 2^k as a float (-126 <= k <= 127): x * fh_pow2(k) is ldexpf(x, k), both
// correctly rounded.
__device__ inline float fh_pow2(int k) { return __int_as_float((127 + k) << 23); }

// The stores of the encoders: fh_store into a bf16 tile (this walk), or
// fp32 into a feature-major [features, ld] tile (fwd_f32.cuh's walk).
struct FhBf16Store {
  unsigned char* buf;
  __device__ void operator()(int p, int c, float v) const {
    fh_store(buf, p, c, v);
  }
};

// The NeRFMLP's PE (mlp_common.cuh::encode) a pair at a time: the
// identity columns, then sin and cos of each x 2^f from one sincosf, which
// gives sinf's and cosf's bits. A tile is TILE points; the encoders are
// the producer's warps 1-3 in both walks.
template <>
struct FhEnc<NerfEnc> {
  template <typename L, int TILE, typename St>
  __device__ static void pe_tile(const float* x, int n, int base, int valid,
                                 int nf, St st) {
    for (int e = threadIdx.x - 288; e < TILE * 3 * (1 + nf);
         e += kFhEncoders) {
      const int p = e % TILE, j = e / TILE;
      float vs = 0.f, vc = 0.f;
      // ---- encode ----
      if (p < valid && j < 3) {
        vs = x[L::at(j, base + p, n, 3)];
      } else if (p < valid) {
        const int f = (j - 3) / 3, r = (j - 3) % 3;
        sincosf(x[L::at(r, base + p, n, 3)] * (float)(1 << f), &vs, &vc);
      }
      // ---- end of the encode ----
      const int c = j < 3 ? j : 3 + 6 * ((j - 3) / 3) + (j - 3) % 3;
      st(p, c, vs);
      if (j >= 3) st(p, c + 3, vc);
    }
  }
  template <typename L, int TILE = kFhTile, typename St = FhBf16Store>
  __device__ static void points(const float* pts, const float*, int n,
                                int base, int valid, const Dims& d, St st) {
    pe_tile<L, TILE>(pts, n, base, valid, d.multires, st);
  }
  template <typename L, int TILE = kFhTile, typename St = FhBf16Store>
  __device__ static void views(const float* views, int n, int base,
                               int valid, const Dims& d, St st) {
    pe_tile<L, TILE>(views, n, base, valid, d.multires_views, st);
  }
};

// The MipMLP's IPE and view encoding (mlp_common.cuh::encode_ipe,
// encode_mip_views) a pair at a time: sin(y) and sin(y + pi/2) share the
// argument, and the IPE pair its damping.
template <>
struct FhEnc<MipEnc> {
  template <typename L, int TILE = kFhTile, typename St = FhBf16Store>
  __device__ static void points(const float* mean, const float* cov, int n,
                                int base, int valid, const Dims& d, St st) {
    const int half = 3 * d.multires;
    for (int e = threadIdx.x - 288; e < TILE * half; e += kFhEncoders) {
      const int p = e % TILE, j = e / TILE, k = j / 3, r = j % 3;
      float vs = 0.f, vc = 0.f;
      // ---- encode ----
      if (p < valid) {
        const size_t at = L::at(r, base + p, n, 3);
        const float y = mean[at] * fh_pow2(k);
        const float damp = expf(-0.5f * (cov[at] * fh_pow2(2 * k)));
        vs = damp * fh_safe_sin(y);
        vc = damp * fh_safe_sin(y + kHalfPi);
      }
      // ---- end of the encode ----
      st(p, j, vs);
      st(p, j + half, vc);
    }
  }
  template <typename L, int TILE = kFhTile, typename St = FhBf16Store>
  __device__ static void views(const float* x, int n, int base, int valid,
                               const Dims& d, St st) {
    const int half = 3 * d.multires_views;
    for (int e = threadIdx.x - 288; e < TILE * (3 + half);
         e += kFhEncoders) {
      const int p = e % TILE, j = e / TILE;
      float vs = 0.f, vc = 0.f;
      // ---- encode ----
      if (p < valid && j < 3) {
        vs = x[L::at(j, base + p, n, 3)];
      } else if (p < valid) {
        const int jj = j - 3;
        const float y = x[L::at(jj % 3, base + p, n, 3)] * fh_pow2(jj / 3);
        vs = fh_safe_sin(y);
        vc = fh_safe_sin(y + kHalfPi);
      }
      // ---- end of the encode ----
      st(p, j, vs);
      if (j >= 3) st(p, j + half, vc);
    }
  }
};

// The k-th tile of this block: tiles b, b + grid, ..., or in #4 the tiles
// of groups b, b + grid, ..., gt tiles a group (a partial last group ends
// the walk at the last tile).
template <int TAIL>
__device__ inline int fh_tile(const FhPlan& pl, int k) {
  if constexpr (TAIL == kFhRender)
    return (blockIdx.x + k / pl.gt * gridDim.x) * pl.gt + k % pl.gt;
  else
    return blockIdx.x + k * gridDim.x;
}

// NP: 6n's encoding-gradient width (the pe rows' products), 0 elsewhere.
// L: the streams' layout (mlp_common.cuh): the inputs [3, n] or [n, 3], the
// raw heads [R, n] or [n, R] (R = 4, 7 with the normals).
template <typename Enc, int NBW, int NBH, int TAIL = kFhHeads, int NP = 0,
          typename L = ColMajor>
__global__ void __launch_bounds__(kFhThreads, 1)
    fwd_hopper_kernel(const float* __restrict__ pts,
                      const float* __restrict__ covs,
                      const float* __restrict__ views,
                      const bf16* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ out,
                      int n, Dims d, FhPlan pl, FhRays rays,
                      const __grid_constant__ WMaps maps) {
  constexpr int NA = NBW > NBH ? NBW : NBH;
  extern __shared__ unsigned char fh_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fh_raw) + 1023) & ~(uintptr_t)1023);
  const FhSmem smo(d, pl.stages, pl.npe, pl.pp, NA, pl.gp);
  const int stages = pl.stages, npe = pl.npe, nprod = d.depth + 2;
  const int W = d.width, H = d.half;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + smo.bars);
  uint64_t* empty = full + stages;
  uint64_t* pe_full = empty + stages;
  uint64_t* pe_empty = pe_full + 2;
  uint64_t* ve_full = pe_empty + 2;
  uint64_t* ve_empty = ve_full + 1;
  uint64_t* heads_full = reinterpret_cast<uint64_t*>(sm + smo.hbars);
  uint64_t* heads_empty = heads_full + 1;
  float* heads = reinterpret_cast<float*>(sm + smo.heads);
  FhProd* prods = reinterpret_cast<FhProd*>(sm + smo.prods);
  float* bias_s = reinterpret_cast<float*>(sm + smo.bias);
  bf16* wa_s = reinterpret_cast<bf16*>(sm + smo.wa);
  bf16* wr_s = reinterpret_cast<bf16*>(sm + smo.wr);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&pe_full[s], kFhEncoders);
      mbar_init(&pe_empty[s], 2);
    }
    mbar_init(ve_full, kFhEncoders);
    mbar_init(ve_empty, 2);
    if constexpr (TAIL == kFhRender) {
      mbar_init(heads_full, 2);
      mbar_init(heads_empty, kFhEncoders);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < nprod) prods[threadIdx.x] = fh_prod(d, threadIdx.x);
  // pe and ve (contiguous) start zero: their padding columns and tails
  // are never written again.
  uint4* z = reinterpret_cast<uint4*>(sm + smo.pe);
  for (int e = threadIdx.x; e < (npe * pl.pp + 1) * kFhPanel / 16;
       e += kFhThreads)
    z[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < fh_bias_floats(d); c += kFhThreads)
    bias_s[c] = c < d.b_views() + H ? b[c] : 0.f;
  for (int c = threadIdx.x; c < W; c += kFhThreads) wa_s[c] = w[d.w_alpha() + c];
  for (int c = threadIdx.x; c < 3 * H; c += kFhThreads)
    wr_s[c] = w[d.w_rgb() + c];
  fence_proxy_async();
  __syncthreads();

  const int n_tiles = pl.tiles;
  if (threadIdx.x >= 256) {
    // ------------------------------ producer ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x < 288) {
      if (threadIdx.x == 256) {  // the weight stream
        unsigned char* ring = sm + smo.ring;
        int issued = 0;
        // The next slab into its ring slot: nbx boxes of map `map`, box bx
        // at (column c0 + 64 bx, row r0) or, transposed (6n's walk back),
        // at (column c0, row r0 + 64 bx).
        auto load_slab = [&](int map, int nbx, int c0, int r0, bool tr) {
          const int slot = issued % stages;
          if (issued >= stages)
            mbar_wait(&empty[slot], (issued / stages - 1) & 1);
          unsigned char* dst = ring + slot * NA * kFhBox;
          mbar_expect_tx(&full[slot], (uint32_t)(nbx * kFhBox));
          for (int bx = 0; bx < nbx; ++bx)
            tma_load_2d(dst + bx * kFhBox, &maps.m[map], &full[slot],
                        tr ? c0 : c0 + 64 * bx, tr ? r0 + 64 * bx : r0);
          ++issued;
        };
        for (int k = 0, tile; (tile = fh_tile<TAIL>(pl, k)) < n_tiles; ++k) {
          for (int q = 0; q < nprod; ++q) {
            const FhProd pr = prods[q];
            for (int j = 0; j < (pr.ks + 3) / 4; ++j)
              load_slab(pr.map, pr.map ? NBH : NBW, 0, pr.row0 + 64 * j,
                        false);
          }
          if constexpr (TAIL == kFhNormals) {
            // ---- the walk back's slabs ----
            // Per layer from the top: the pe rows' slabs (layer 0, the
            // post-skip layers), then the h rows'; slab j holds the
            // layer's columns 64 j .. 64 j + 63.
            for (int l = d.depth - 1; l >= 0; --l) {
              const int r0 = (int)(d.w_layer(l) / W);
              if (l == 0 || d.skip_before(l))
                for (int j = 0; j < W / 64; ++j)
                  load_slab(0, (d.P + 63) / 64, 64 * j, r0, true);
              if (l > 0)
                for (int j = 0; j < W / 64; ++j)
                  load_slab(0, NBW, 64 * j,
                            r0 + (d.skip_before(l) ? d.P : 0), true);
            }
            // ---- end of the walk back's slabs ----
          }
        }
      }
    } else {  // the encoders (and #4's compositing)
      // #4: group gi's rays, a warp a ray, once the consumers have
      // written its last rgb head; then the buffer goes back.
      auto composite = [&](int gi) {
        mbar_wait(heads_full, gi & 1);
        const int S = rays.seg, per = pl.gp / S;
        const int ray0 = (blockIdx.x + gi * gridDim.x) * per;
        for (int r = (threadIdx.x - 288) / 32;
             r < per && ray0 + r < rays.n_rays; r += kFhEncoders / 32) {
          const int ray = ray0 + r;
          fh_composite_ray(heads + r * S, pl.gp, rays.z + (size_t)ray * S,
                           rays.dn[ray], S, rays.white != 0, out, (size_t)n,
                           (size_t)ray * S);
        }
        mbar_arrive(heads_empty);
      };
      int k = 0;
      for (int tile; (tile = fh_tile<TAIL>(pl, k)) < n_tiles; ++k) {
        const int base = tile * kFhTile, valid = min(kFhTile, n - base);
        const int pb = k % npe;
        if (k >= npe) mbar_wait(&pe_empty[pb], (k / npe - 1) & 1);
        FhEnc<Enc>::template points<L>(
            pts, covs, n, base, valid, d,
            FhBf16Store{sm + smo.pe + pb * pl.pp * kFhPanel});
        fence_proxy_async();
        mbar_arrive(&pe_full[pb]);
        if (k >= 1) mbar_wait(ve_empty, (k - 1) & 1);
        FhEnc<Enc>::template views<L>(views, n, base, valid, d,
                                      FhBf16Store{sm + smo.ve});
        fence_proxy_async();
        mbar_arrive(ve_full);
        if constexpr (TAIL == kFhRender)
          if (k > 0 && k % pl.gt == 0) composite(k / pl.gt - 1);
      }
      if constexpr (TAIL == kFhRender)
        if (k > 0) composite((k - 1) / pl.gt);
    }
  } else {
    // ------------------------------ consumers -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
    const bool lead = lt == 0;
    unsigned char* rows = sm + smo.act + wg * 64 * 128;
    const uint32_t ring = smem_u32(sm + smo.ring);
    const uint32_t act_a = smem_u32(rows);
    const uint32_t ve_a = smem_u32(sm + smo.ve) + wg * 64 * 128;
    const int zsrc = fh_zero_src(d, pl.pp);
    int last_pe = 0;  // the last product that reads pe
    for (int q = 1; q < d.depth; ++q)
      if (d.skip_before(q)) last_pe = q;
    const float ba = b[d.b_alpha()];
    const float* br = b + d.b_rgb();
    // Where the heads of a row go: device memory (out's R channels n apart,
    // or with L row-major each point's R channels together) or, in #4, the
    // group's buffer in shared memory (channels gp apart): channel c of
    // row r at h0[c cs + r rs].
    constexpr int R = TAIL == kFhNormals ? 7 : 4;
    constexpr bool row_out = L::kRow && TAIL != kFhRender;
    constexpr int rs = row_out ? R : 1;
    const size_t cs = TAIL == kFhRender ? (size_t)pl.gp
                      : row_out         ? (size_t)1
                                        : (size_t)n;
    // The heads, one thread a row (alpha) or a row and channel (rgb), of
    // this warpgroup's rows from h0 (valid: rows there that are points).
    auto alpha = [&](float* h0, int valid) {
      // ---- alpha head ----
      if (lt < 64 && lt < valid)
        h0[3 * cs + lt * rs] = fh_row_dot(rows, lt, wa_s, W) + ba;
      // ---- end of the alpha head ----
    };
    auto rgb = [&](float* h0, int valid) {
      // ---- rgb head ----
      for (int e = lt; e < 3 * 64; e += 128) {
        const int r = e % 64, c = e / 64;
        if (r < valid)
          h0[c * cs + r * rs] = fh_row_dot(rows, r, wr_s + c * H, H) + br[c];
      }
      // ---- end of the rgb head ----
    };
    float acc[32 * NA];
#pragma unroll
    for (int r = 0; r < 32 * NA; ++r) acc[r] = 0.f;
    // 6n: the trunk's masks, and the encoding's gradient.
    constexpr int MW = TAIL == kFhNormals ? kFhMaskDepth * NBW : 1;
    uint32_t mk[MW];
    float accp[TAIL == kFhNormals ? NP / 2 : 1];
    int t = 0, k = 0, valid_prev = 0;
    float* h_prev = nullptr;
    for (int tile; (tile = fh_tile<TAIL>(pl, k)) < n_tiles; ++k) {
      const int pb = k % npe;
      const uint32_t pe_a = smem_u32(sm + smo.pe + pb * pl.pp * kFhPanel) +
                            wg * 64 * 128;
      const uint32_t az = zsrc ? ve_a + 2 * d.V : pe_a + fh_col(d.P);
      const int g0 = tile * kFhTile + 64 * wg;  // this warpgroup's row 0
      const int valid = n - g0;                 // rows past it are padding
      float* h0 = TAIL == kFhRender
                      ? heads + (k % pl.gt) * kFhTile + 64 * wg
                      : out + (size_t)g0 * rs;
      if constexpr (TAIL == kFhNormals) {
#pragma unroll
        for (int r = 0; r < MW; ++r) mk[r] = 0u;
      }
      mbar_wait(&pe_full[pb], (k / npe) & 1);
      for (int q = 0; q < d.depth; ++q) {
        const bool pe_in = q == 0 || d.skip_before(q);
        // Layer 0 reads pe only: the previous tile's rgb head reads hv
        // from the tile meanwhile.
        fh_product<NBW, NA>(acc, ring, full, empty, stages, t,
                            pe_in ? pe_a : act_a, pe_in ? d.P / 16 : W / 16,
                            act_a, q > 0 && pe_in ? W / 16 : 0, az, [&] {
                              if (TAIL != kFhNormals && q == 0 && k > 0)
                                rgb(h_prev, valid_prev);
                            });
        if (q == last_pe && lead) mbar_arrive(&pe_empty[pb]);
        if (q == 0) {
          bar_sync(1 + wg, 128);  // rgb has read hv
          // #4: the previous tile was its group's last: hand the heads on.
          if constexpr (TAIL == kFhRender)
            if (k > 0 && k % pl.gt == 0 && lead) mbar_arrive(heads_full);
        }
        if constexpr (TAIL == kFhNormals) {
          fh_mask_push<NBW>(mk);
          fh_epilogue<NBW, NA, true, true>(acc, bias_s + d.b_layer(q), rows,
                                           mk);
        } else {
          fh_epilogue<NBW, NA, true>(acc, bias_s + d.b_layer(q), rows);
        }
        fence_proxy_async();
        bar_sync(1 + wg, 128);
      }
      // #4: a group's first alpha head waits for the heads buffer.
      if constexpr (TAIL == kFhRender)
        if (k > 0 && k % pl.gt == 0)
          mbar_wait(heads_empty, (k / pl.gt - 1) & 1);
      // The feature layer reads h: the alpha head reads it meanwhile.
      fh_product<NBW, NA>(acc, ring, full, empty, stages, t, act_a, W / 16,
                          act_a, 0, az, [&] { alpha(h0, valid); });
      bar_sync(1 + wg, 128);  // alpha has read h
      fh_epilogue<NBW, NA, false>(acc, bias_s + d.b_feature(), rows);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      mbar_wait(ve_full, k & 1);
      fh_product<NBH, NA>(acc, ring, full, empty, stages, t, act_a, W / 16,
                          ve_a, d.V / 16, az, [] {});
      if (lead) mbar_arrive(ve_empty);
      fh_epilogue<NBH, NA, true>(acc, bias_s + d.b_views(), rows);
      bar_sync(1 + wg, 128);
      if constexpr (TAIL == kFhNormals) {
        // The rgb head now: the walk back overwrites hv.
        rgb(h0, valid);
        bar_sync(1 + wg, 128);
        // ---- normals backward ----
        // g at the top layer's output: wd, masked and rounded.
        fh_grad_epilogue<NBW, NA, true>(acc, wa_s, mk, rows);
        fh_mask_pop<NBW>(mk);
        fence_proxy_async();
        bar_sync(1 + wg, 128);
        bool pe_on = false;  // accp holds a pe product's sum
#pragma unroll
        for (int r = 0; r < NP / 2; ++r) accp[r] = 0.f;
        for (int l = d.depth - 1; l >= 0; --l) {
          if (l == 0 || d.skip_before(l)) {  // the encoding's gradient
            fh_product_n<NP, 0, NA>(accp, ring, full, empty, stages, t,
                                    act_a, W / 16, act_a, 0, act_a, pe_on,
                                    [] {});
            pe_on = true;
          }
          if (l > 0) {  // g at layer l - 1's output
            fh_product_n<64 * NBW, 0, NA>(acc, ring, full, empty, stages, t,
                                          act_a, W / 16, act_a, 0, act_a,
                                          false, [] {});
            fh_grad_epilogue<NBW, NA, false>(acc, wa_s, mk, rows);
            fh_mask_pop<NBW>(mk);
            fence_proxy_async();
            bar_sync(1 + wg, 128);
          }
        }
        // ---- end of the normals backward ----
        // ---- jacobian ----
        // The encoding's gradient (64 rows x NP, fp32) into this
        // warpgroup's rows of the tile: column c of row r at rows +
        // (c / 32) kFhPanel + 128 r + 4 (c % 32).
        {
          const int lane = lt % 32, wq = lt / 32;
          bar_sync(1 + wg, 128);  // every warp's products have read rows
#pragma unroll
          for (int a = 0; a < NP / 2; a += 2) {
            const int r = 16 * wq + lane / 4 + 8 * ((a % 4) / 2);
            const int c = 8 * (a / 4) + 2 * (lane % 4);
            *reinterpret_cast<float2*>(rows + (c / 32) * kFhPanel + 128 * r +
                                       4 * (c % 32)) =
                make_float2(accp[a], accp[a + 1]);
          }
          bar_sync(1 + wg, 128);
        }
        // Feature 3 k + r is damp sin(y), feature 3 F + 3 k + r damp
        // sin(y + pi/2), y = mean_r 2^k (FhEnc<MipEnc>): d mean_r sums
        // 2^k damp (g_sin cos(y) + g_cos cos(y + pi/2)) over k.
        for (int e = lt; e < 3 * 64; e += 128) {
          const int p = e % 64, r = e / 64, F = d.multires;
          if (p >= valid) continue;
          const size_t at = L::at(r, g0 + p, n, 3);
          const float mean = pts[at], cov = covs[at];
          const unsigned char* gr = rows + 128 * p;
          float s = 0.f;
          for (int kq = 0; kq < F; ++kq) {
            const int c0 = 3 * kq + r, c1 = 3 * (F + kq) + r;
            const float g_s = *reinterpret_cast<const float*>(
                gr + (c0 / 32) * kFhPanel + 4 * (c0 % 32));
            const float g_c = *reinterpret_cast<const float*>(
                gr + (c1 / 32) * kFhPanel + 4 * (c1 % 32));
            const float y = mean * fh_pow2(kq);
            const float damp = expf(-0.5f * (cov * fh_pow2(2 * kq)));
            const float a0 = g_s * damp * safe_cos(y);
            const float a1 = g_c * damp * safe_cos(y + kHalfPi);
            s += a0 * fh_pow2(kq) + a1 * fh_pow2(kq);
          }
          out[L::at(4 + r, g0 + p, n, R)] = s;
        }
        // ---- end of the jacobian ----
        // (The next tile's layer 0 writes rows after a barrier.)
      }
      h_prev = h0;
      valid_prev = valid;
    }
    if (TAIL != kFhNormals && k > 0) {
      rgb(h_prev, valid_prev);
      if constexpr (TAIL == kFhRender) {
        bar_sync(1 + wg, 128);
        if (lead) mbar_arrive(heads_full);
      }
    }
  }
}

// The plan at these shapes. `instance`: the source holds the kernel for
// (width / 64, ceil(half / 64)) (under both layouts: the plan is the same
// for both). The walk takes bf16 on either layout, widths
// that are multiples of 64 up to 256, a view layer up to 256 wide, P up
// to 128 and V up to 64 columns, heads on h alone with the view branch
// (no skip into the heads, no output head: the v1 shapes past #1's), zero
// columns for the steps past each reduction, and a shared memory that
// holds two pe buffers and a ring of 3 slots, or 2 (else one pe buffer),
// and, for #4, the heads of a group of gp points (0 elsewhere). Returns a
// cudaError_t.
inline int fh_plan(const Dims& d, int n, bool bf16_, bool instance,
                   FhPlan* pl, int gp = 0) {
  *pl = FhPlan{};
  pl->tiles = (n + kFhTile - 1) / kFhTile;
  pl->gp = gp;
  pl->gt = gp ? gp / kFhTile : 1;
  const int nbw = d.width / 64, nbh = (d.half + 63) / 64;
  pl->na = nbw > nbh ? nbw : nbh;
  pl->pp = (d.P + 63) / 64;
  if (!(bf16_ && instance && d.width % 64 == 0 && d.width <= 256 &&
        d.half % 16 == 0 && d.half <= 256 && d.P <= 128 && d.V <= 64 &&
        d.depth >= 1 && d.depth + 2 <= kFhMaxProds && !d.head_skip() &&
        d.out_ch == 0 && fh_zero_src(d, pl->pp) >= 0))
    return 0;
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // Two pe buffers first (the mip's 96-column IPE cannot wait for the skip
  // layer), then the deepest ring that fits beside them.
  for (pl->npe = 2; pl->npe >= 1; --pl->npe) {
    for (pl->stages = 3; pl->stages >= 2; --pl->stages) {
      pl->smem = FhSmem(d, pl->stages, pl->npe, pl->pp, pl->na, gp).total;
      if (pl->smem <= smem_max) break;
    }
    if (pl->stages >= 2) break;
  }
  if (pl->npe == 0) return 0;  // nothing fits: fwd_tile
  pl->ok = 1;
  const int groups = (pl->tiles + pl->gt - 1) / pl->gt;
  pl->grid = groups < sms ? groups : sms;
  return 0;
}

template <typename Enc, int NBW, int NBH, int TAIL = kFhHeads, int NP = 0,
          typename L = ColMajor>
int fh_launch(const FhPlan& pl, const void* pts, const void* covs,
              const void* views, const void* w, const void* b, void* out,
              int n, const Dims& d, cudaStream_t stream,
              const FhRays& rays = FhRays{}) {
  // TMA reads the weights: 16-byte aligned base (the row strides, 2 W and
  // 2 half bytes, and the view layer's offset are multiples of 16 at
  // these widths).
  if (reinterpret_cast<uintptr_t>(w) % 16) return (int)cudaErrorMisalignedAddress;
  WMaps maps = {};
  int err = weight_maps(d, static_cast<const bf16*>(w), &maps);
  if (err) return err;
  auto kernel = fwd_hopper_kernel<Enc, NBW, NBH, TAIL, NP, L>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<pl.grid, kFhThreads, pl.smem, stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(covs),
      static_cast<const float*>(views), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), n, d, pl, rays,
      maps);
  return (int)cudaGetLastError();
}

// The NeRFMLP's instances of the walk (#1, #4, and under RowMajor #10 and
// #12 / #13): (width / 64, ceil(half / 64)) at widths 64, 128, 192, 256
// (half = width / 2).
inline bool fh_nerf_instance(const Dims& d) {
  const int nbw = d.width / 64, nbh = (d.half + 63) / 64;
  return (nbw == 1 && nbh == 1) || (nbw == 2 && nbh == 1) ||
         (nbw == 3 && nbh == 2) || (nbw == 4 && nbh == 2);
}

template <int TAIL, typename L = ColMajor>
int fh_nerf_launch(const FhPlan& pl, const void* pts, const void* views,
                   const void* w, const void* b, void* out, int n,
                   const Dims& d, cudaStream_t s,
                   const FhRays& rays = FhRays{}) {
  switch (d.width / 64) {
    case 1:
      return fh_launch<NerfEnc, 1, 1, TAIL, 0, L>(pl, pts, nullptr, views, w,
                                                  b, out, n, d, s, rays);
    case 2:
      return fh_launch<NerfEnc, 2, 1, TAIL, 0, L>(pl, pts, nullptr, views, w,
                                                  b, out, n, d, s, rays);
    case 3:
      return fh_launch<NerfEnc, 3, 2, TAIL, 0, L>(pl, pts, nullptr, views, w,
                                                  b, out, n, d, s, rays);
    default:
      return fh_launch<NerfEnc, 4, 2, TAIL, 0, L>(pl, pts, nullptr, views, w,
                                                  b, out, n, d, s, rays);
  }
}

}  // namespace mlp
