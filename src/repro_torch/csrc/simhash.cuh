// SimHash scores of one row, shared by simhash_codes.cu and lss_topk.cu
// (the fused kernel's stage 1 is exactly this hash).
//
// Bit j of table t is  sum_i x[i] * theta[i, t*K + j] > 0  (strictly: a
// score of 0 gives bit 0), packed little-endian: bit j weighs 2^j.
//
// One warp computes one score: the lanes split the d elements, and a
// shuffle reduction sums the partials, so the dependent chain is ~d/32
// fmas + 5 shuffles per bit instead of d fmas on one thread.  Lane 0's
// sum is broadcast, so every lane sees the same bit.  The sum runs in
// fp32 in another order than a matrix product's, so a bit can differ from
// the plain version only where |score| is within rounding of 0; both
// kernels sum in the same order, so they give the same bits.
#pragma once

// theta [d, K*L] (row-major, global) -> theta_t [K*L, d] (shared), so that
// consecutive lanes read consecutive words of one hyperplane.
__device__ __forceinline__ void load_theta_transposed(
    const float* __restrict__ theta, float* __restrict__ theta_t, int d,
    int kl) {
  for (int idx = threadIdx.x; idx < d * kl; idx += blockDim.x)
    theta_t[(idx % kl) * d + idx / kl] = theta[idx];
}

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

// Called by all 32 lanes of a warp; x and theta_t in shared memory.
__device__ __forceinline__ int simhash_table_code(
    const float* __restrict__ x, const float* __restrict__ theta_t, int d,
    int k_bits, int t, int lane) {
  int code = 0;
  for (int j = 0; j < k_bits; ++j) {
    const float s = simhash_score(x, theta_t + (t * k_bits + j) * d, 1, d,
                                  lane);
    code |= (s > 0.f ? 1 : 0) << j;
  }
  return code;
}
