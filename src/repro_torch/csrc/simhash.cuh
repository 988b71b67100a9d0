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

// The code of one table: its k_bits <= kMaxK scores in one pass over d.
// Called by all 32 lanes of a warp; x [d] and theta in shared memory, row
// i of theta at theta + i * stride, the table's hyperplanes in columns
// col0 .. col0 + k_bits - 1.  Each lane keeps k_bits partials, summed as
// simhash_score sums; warp_sum8 then reduces 8 scores at a time with the
// same tree, and a ballot gathers their signs.
template <int kMaxK>
__device__ __forceinline__ int simhash_table_code(
    const float* __restrict__ x, const float* __restrict__ theta, int stride,
    int d, int k_bits, int col0, int lane) {
  static_assert(kMaxK % 8 == 0, "scores are reduced 8 at a time");
  float acc[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) acc[j] = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xi = x[i];
    const float* h = theta + i * stride + col0;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k_bits) acc[j] = fmaf(xi, h[j], acc[j]);
  }
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
