// Fine-level resampling of the vanilla renderer: inverse-CDF sampling over
// the coarse weights and the merge of the samples with the coarse depths,
// one kernel.
//
// Replaces the Pallas TPU kernel consistentnerf_tpu/ops/pdf_merge.py::
// sample_pdf_merged. Input per ray: the ascending coarse depths z_c [S_c],
// the interior compositing weights w [S_c - 2] and ascending draws u [S_i]
// in [0, 1], fp32, S_c and S_i <= 128, each row read through its row
// stride (a stride of 0 hands every ray the same row, as the deterministic
// draws do), its last dimension unit-stride. Output per ray: the samples
// z_s [S_i] and sort(concat(z_c, z_s)) [S_c + S_i]. The function is
// core/sampling.py::sample_pdf over the midpoints of z_c
// (run_nerf_helpers.py:206-250): pdf = (w + 1e-5) / sum, the exclusive
// cdf, below / above = the interval with cdf_k <= u < cdf_{k+1} (the last
// interval closed on the right), the denominator 1 where it is below
// 1e-5, linear interpolation of the midpoints.
//
// Bound: bytes. A ray moves 2,296 bytes (z_c 256, w 248, u 512 in; merged
// 768, z_s 512 out at S_c = 64, S_i = 128) for ~1k operations, so an
// 8192-ray chunk needs at least 5.6 us at 3.35 TB/s. The chunk is one
// wave of rays on the card, so every ray's loads, arithmetic and stores
// happen at about the same time: the design issues all of a ray's loads
// first, keeps its serial work off single lanes and its searches short,
// and stores whole rows:
//
// * A group of G = 16 lanes takes a ray (two rays a warp), its depths,
//   midpoints and cdf in shared memory.
// * Lane l holds the entries [l E, l E + E), E = ceil((S_c - 2) / G), of
//   w + 1e-5 in registers. The sum is a butterfly of the lane sums
//   (__shfl_xor_sync, the same bits in every lane), each lane divides its
//   own entries by it, and the exclusive cdf of pdf = (w + 1e-5) / sum is
//   the lane's serial prefix plus a log-step __shfl_up_sync scan of the
//   lane totals: the TPU kernel's order (pdf first, then its log-step
//   prefix _row_prefix_excl), not the plain version's index-order sum. As
//   in both, the cdf's last entry is 1 only up to the rounding of its
//   sums, and where it rounds above 1 the draw u = 1 falls in the last
//   interval but one.
// * Lane l takes the draws [l D, l D + D), D = ceil(S_i / G) (16-byte
//   loads where the rows allow), finds their intervals
//   cdf_k <= u < cdf_{k+1} by branchless binary searches of the cdf that
//   take each step together, so their loads overlap (`count_below`),
//   interpolates the midpoints, and stores its samples (16 bytes at a time
//   where it can).
// * The merge needs no sort, since both rows ascend: z_s[j] goes to
//   j + #{z_c <= z_s[j]}, and a sample in interval k lies at or above
//   mid_k >= z_c[k], so the count starts at k + 1 and steps over the next
//   depths (usually one compare). The samples are scattered into a row in
//   shared memory; the depths fill its holes in order (a ballot a slot
//   chunk), and the row goes out whole, coalesced.
// * The inverse CDF is monotone, but fp32 rounding can put one sample an
//   ulp above the next where two intervals meet. A warp vote finds such a
//   pair; each sample then takes the rank #{smaller} + #{equal with a
//   lower index} and is scattered to it, so the samples come out sorted
//   and the positions stay a permutation.
//
// The arithmetic rounds where the plain PyTorch version rounds (no fused
// multiply-add), and nothing crosses groups: a second launch gives the
// same bits. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 128;
constexpr unsigned kAll = 0xffffffffu;
constexpr int G = 16;  // lanes a ray: two rays a warp

// lo[e] = #{i < n: a[i] <= x[e]} (kLe) or #{i < n: a[i] < x[e]} for the
// ascending a[0, n), 1 <= n <= 128, top the largest power of two <= n:
// one probe that leaves top candidates, then a fixed binary lifting, no
// bounds checks. The N searches take each step together, so their loads
// overlap.
template <bool kLe, int N>
__device__ __forceinline__ void count_below(const float* a, int n, int top,
                                            const float (&x)[N],
                                            int (&lo)[N]) {
  const float y = a[top - 1];
#pragma unroll
  for (int e = 0; e < N; ++e)
    lo[e] = (kLe ? y <= x[e] : y < x[e]) ? n - top + 1 : 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1)
    if (step < top) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float v = a[lo[e] + step - 1];
        if (kLe ? v <= x[e] : v < x[e]) lo[e] += step;
      }
    }
}

__device__ __forceinline__ int top_pow2(int n) { return 1 << (31 - __clz(n)); }

__device__ __forceinline__ bool aligned16(const void* p, int ld) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) | (ld & 3)) == 0;
}

// A free slot of the merged row in shared memory (a NaN no arithmetic
// makes).
constexpr unsigned kHole = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    pdf_merge_kernel(const float* __restrict__ zc, int ldz,
                     const float* __restrict__ w, int ldw,
                     const float* __restrict__ u, int ldu,
                     float* __restrict__ merged, float* __restrict__ zs_out,
                     int n, int s_c, int s_i) {
  constexpr int kE = kMax / G;  // register entries a lane
  // The rows of a ray, 3 kMax + 4 floats apart, so that the two rays of
  // a warp at G = 16 probe the same index in other banks.
  __shared__ __align__(16) float s_rows[kThreads / G][3 * kMax + 4];
  const int sub = threadIdx.x % G, slot = threadIdx.x / G;
  const int ray = blockIdx.x * (kThreads / G) + slot;
  // A group past the last ray works on the last one and stores nothing,
  // so every lane of a warp reaches the shuffles.
  const bool valid = ray < n;
  const size_t r = valid ? ray : n - 1;
  float* z = s_rows[slot];
  float* mid = z + kMax;
  float* cdf = mid + kMax;
  float* row = mid;  // the merged row, over mid and cdf
  const int m = s_c - 1, np = s_c - 2;  // cdf entries, pdf entries
  const int e_n = (np + G - 1) / G, k0 = sub * e_n;
  const int d_n = (s_i + G - 1) / G, j0 = sub * d_n;
  const bool vec = d_n * G == s_i && (d_n & 3) == 0;
  bool draw[kE];  // the lane's draw slots that hold a draw
#pragma unroll
  for (int e = 0; e < kE; ++e) draw[e] = e < d_n && j0 + e < s_i;

  // Every load first: the weights and draws into registers, the depths
  // into shared memory.
  const float* wr = w + r * ldw;
  const float* ur = u + r * ldu;
  float c[kE], x[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e)
    c[e] = e < e_n && k0 + e < np ? __ldg(wr + k0 + e) : 0.f;
  if (vec && aligned16(u, ldu)) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q)
      if (4 * q < d_n) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(ur + j0) + q);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (draw[e]) x[e] = __ldg(ur + j0 + e);
  }
  const float* zr = zc + r * ldz;
  if (aligned16(zc, ldz)) {
    for (int k = sub; 4 * k < (s_c & ~3); k += G)
      reinterpret_cast<float4*>(z)[k] =
          __ldg(reinterpret_cast<const float4*>(zr) + k);
    for (int k = (s_c & ~3) + sub; k < s_c; k += G) z[k] = __ldg(zr + k);
  } else {
    for (int k = sub; k < s_c; k += G) z[k] = __ldg(zr + k);
  }

  // pdf_k = (w_k + 1e-5) / sum, the sum a butterfly of the lane sums;
  // cdf_k = pdf_0 + ... + pdf_{k-1}: the lane's serial prefix, a log-step
  // scan of the lane totals.
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < e_n && k0 + e < np) {
      c[e] = __fadd_rn(c[e], 1e-5f);
      part = __fadd_rn(part, c[e]);
    }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(kAll, part, off, G));
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < e_n && k0 + e < np) {
      run = __fadd_rn(run, __fdiv_rn(c[e], part));
      c[e] = run;
    }
  float incl = run;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float y = __shfl_up_sync(kAll, incl, off, G);
    if (sub >= off) incl = __fadd_rn(incl, y);
  }
  float base = __shfl_up_sync(kAll, incl, 1, G);
  if (sub == 0) {
    base = 0.f;
    cdf[0] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < e_n && k0 + e < np) cdf[k0 + e + 1] = __fadd_rn(base, c[e]);
  __syncwarp();
  for (int i = sub; i < m; i += G)
    mid[i] = __fmul_rn(0.5f, __fadd_rn(z[i + 1], z[i]));
  __syncwarp();

  // The draws: interval, interpolation. A lane's slots past the row
  // search for 0 and store nothing.
  int below[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (!draw[e]) x[e] = 0.f;
  count_below<true>(cdf, m, top_pow2(m), x, below);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int lo = max(below[e] - 1, 0), hi = min(below[e], m - 1);
    const float c0 = cdf[lo], c1 = cdf[hi];
    float denom = __fsub_rn(c1, c0);
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(x[e], c0), denom);
    const float b0 = mid[lo], b1 = mid[hi];
    x[e] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));
    below[e] = lo;
  }
  // The first sample of the next lane, for the order check.
  float next = __shfl_down_sync(kAll, x[0], 1, G);
  bool inverted = false;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (draw[e] && j0 + e + 1 < s_i)
      inverted |= (e + 1 < d_n ? x[e + 1 < kE ? e + 1 : e] : next) < x[e];
  __syncwarp();  // mid and cdf are read; the merged row takes their place
  float* zs = row + kMax;  // scratch for the fix-up, over cdf
  const bool resorted = __any_sync(kAll, inverted);
  if (resorted) {  // rare: rank each sample, scatter
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (draw[e]) zs[j0 + e] = x[e];
    __syncwarp();
    int rank[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (draw[e]) {
        int k = 0;
        for (int i = 0; i < s_i; ++i) {
          const float y = zs[i];
          k += y < x[e] || (y == x[e] && i < j0 + e);
        }
        rank[e] = k;
      }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (draw[e]) zs[rank[e]] = x[e];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (draw[e]) x[e] = zs[j0 + e];
    __syncwarp();
  }

  // Positions j + #{z_c <= z_s[j]}. A sample in interval k is at least
  // mid_k >= z_c[k], so the count starts at k + 1 and steps over the next
  // depths: two steps for all the lane's samples together (one usually
  // settles it), the rest one by one. After a fix-up, searched.
  int p[kE];
  if (resorted) {
    count_below<true>(z, s_c, top_pow2(s_c), x, p);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) p[e] = below[e] + 1;
#pragma unroll
    for (int step = 0; step < 2; ++step)
#pragma unroll
      for (int e = 0; e < kE; ++e)
        p[e] += p[e] < s_c && z[min(p[e], s_c - 1)] <= x[e];
#pragma unroll
    for (int e = 0; e < kE; ++e)
      while (p[e] < s_c && z[p[e]] <= x[e]) ++p[e];
  }
  // The samples into the merged row; its holes take z_c in order.
  const int s_m = s_c + s_i;
  for (int k = sub; k < s_m; k += G) row[k] = __uint_as_float(kHole);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (draw[e]) row[j0 + e + p[e]] = x[e];
  __syncwarp();
  const int lane = threadIdx.x % 32, first = lane - sub;
  const unsigned below_me = (1u << sub) - 1u;
  float* mo = merged + r * s_m;
  int holes = 0;
#pragma unroll 4
  for (int chunk = 0; chunk < s_m; chunk += G) {
    const int k = chunk + sub;
    const float v = k < s_m ? row[k] : 0.f;
    const bool hole = k < s_m && __float_as_uint(v) == kHole;
    const unsigned mask =
        (__ballot_sync(kAll, hole) >> first) & ((1u << G) - 1u);
    if (valid && k < s_m)
      mo[k] = hole ? z[holes + __popc(mask & below_me)] : v;
    holes += __popc(mask);
  }
  if (!valid) return;
  float* so = zs_out + r * s_i;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q)
      if (4 * q < d_n)
        reinterpret_cast<float4*>(so + j0)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (draw[e]) so[j0 + e] = x[e];
  }
}

}  // namespace

// z_c: [n, s_c] ascending, row stride ldz; w: [n, s_c - 2], row stride
// ldw; u: [n, s_i] ascending in [0, 1], row stride ldu (0: one row for
// every ray); each row unit-stride. merged: [n, s_c + s_i]; z_s: [n, s_i];
// contiguous. All fp32; 3 <= s_c <= 128, 1 <= s_i <= 128. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pdf_merge(const void* z_c, int ldz, const void* w, int ldw,
                         const void* u, int ldu, void* merged, void* z_s,
                         int n, int s_c, int s_i, void* stream) {
  if (n <= 0) return 0;
  if (s_c < 3 || s_c > kMax || s_i < 1 || s_i > kMax || ldz < 0 ||
      ldw < 0 || ldu < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int rays = kThreads / G;
  pdf_merge_kernel<<<(n + rays - 1) / rays, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z_c), ldz, static_cast<const float*>(w), ldw,
      static_cast<const float*>(u), ldu, static_cast<float*>(merged),
      static_cast<float*>(z_s), n, s_c, s_i);
  return (int)cudaGetLastError();
}
