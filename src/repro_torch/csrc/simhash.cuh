// SimHash scores, shared by simhash_codes.cu and lss_topk.cu (the fused
// kernel's stage 1 is exactly this hash).
//
// Bit j of table t is  sum_i x[i] * theta[i, t*K + j] > 0  (strictly: a
// score of 0 gives bit 0), packed little-endian: bit j weighs 2^j.
//
// A warp sums one score: lane l takes the elements i = l, l + 32, ... in
// order, one fmaf each, and a shuffle tree sums the 32 partials.  The sum
// runs in fp32 in another order than a matrix product's, so a bit can
// differ from the plain version only where |score| is within rounding of
// 0.  simhash_score and simhash_table_code sum every score in the same
// order (warp_reduce.cuh), so both kernels give the same bits.
#pragma once

#include "warp_reduce.cuh"

// sum_i x[i] * h[i * stride] over the warp; called by all 32 lanes.
__device__ __forceinline__ float simhash_score(const float* __restrict__ x,
                                               const float* __restrict__ h,
                                               int stride, int d, int lane) {
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = fmaf(x[i], h[i * stride], s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
  return __shfl_sync(0xFFFFFFFFu, s, 0);
}

// simhash_score of x / denom, each element divided as it is read: the
// same products, bit for bit, as simhash_score over a stored copy of
// x / denom (lss_topk's wide layout keeps one copy of q, not two).
__device__ __forceinline__ float simhash_score_div(
    const float* __restrict__ x, float denom, const float* __restrict__ h,
    int stride, int d, int lane) {
  float s = 0.f;
#pragma unroll 8
  for (int i = lane; i < d; i += 32)
    s = fmaf(x[i] / denom, h[static_cast<size_t>(i) * stride], s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
  return __shfl_sync(0xFFFFFFFFu, s, 0);
}

// The code of one table, in two parts so that a caller can feed d in
// tiles: simhash_accumulate adds elements [0, d) of x and theta's rows to
// each lane's k_bits partials (lane l takes i = l, l + 32, ... in order,
// one fmaf each, as simhash_score does), and simhash_code reduces them.
// Tiles whose widths are multiples of 32 keep every lane's order, so a
// tiled pass gives the same sums as one pass over the whole of d.
// Called by all 32 lanes of a warp; row i of theta at theta + i * stride,
// the table's hyperplanes in columns col0 .. col0 + k_bits - 1.
template <int kMaxK>
__device__ __forceinline__ void simhash_accumulate(
    const float* __restrict__ x, const float* __restrict__ theta, int stride,
    int d, int k_bits, int col0, int lane, float (&acc)[kMaxK]) {
  for (int i = lane; i < d; i += 32) {
    const float xi = x[i];
    const float* h = theta + i * stride + col0;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k_bits) acc[j] = fmaf(xi, h[j], acc[j]);
  }
}

// The table's code from the lanes' partials: warp_sum8 reduces 8 scores
// at a time with simhash_score's tree, and a ballot gathers their signs.
template <int kMaxK>
__device__ __forceinline__ int simhash_code(const float (&acc)[kMaxK],
                                            int k_bits, int lane) {
  static_assert(kMaxK % 8 == 0, "scores are reduced 8 at a time");
  unsigned code = 0;
#pragma unroll
  for (int g = 0; g < kMaxK; g += 8) {
    if (g >= k_bits) break;
    float a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = acc[g + u];
    // lanes 4u .. 4u + 3 hold score g + u
    const unsigned pos = __ballot_sync(0xFFFFFFFFu, warp_sum8(a, lane) > 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) code |= (pos >> (4 * u) & 1u) << (g + u);
  }
  return static_cast<int>(code & ((1u << k_bits) - 1u));
}

// The code of one table: its k_bits <= kMaxK scores in one pass over d
// (x [d] and theta in shared memory).
template <int kMaxK>
__device__ __forceinline__ int simhash_table_code(
    const float* __restrict__ x, const float* __restrict__ theta, int stride,
    int d, int k_bits, int col0, int lane) {
  float acc[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) acc[j] = 0.f;
  simhash_accumulate<kMaxK>(x, theta, stride, d, k_bits, col0, lane, acc);
  return simhash_code<kMaxK>(acc, k_bits, lane);
}
