// Warp reductions shared by the kernels.
#pragma once

// Sum of a[u] over the warp for 8 values at once: a transposed butterfly
// (4 + 2 + 1 + 2 shuffles instead of 8 x 5).  Lane l returns the sum of
// a[(l >> 2) & 7].
//
// Every lane's sum is the same tree over the 32 partials: lanes that differ
// in bit 4 are added first, then bit 3, 2, 1 and 0.  That is the tree of
// five __shfl_down_sync steps (16, 8, 4, 2, 1) as lane 0 sees it, and fp32
// addition is commutative, so the sum is bit for bit the one that a
// shfl_down reduction leaves in lane 0.
__device__ __forceinline__ float warp_sum8(const float (&a)[8], int lane) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float b[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = (h16 ? a[k + 4] : a[k]) +
           __shfl_xor_sync(kAll, h16 ? a[k] : a[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = (h8 ? b[k + 2] : b[k]) +
           __shfl_xor_sync(kAll, h8 ? b[k] : b[k + 2], 8);
  float e = (h4 ? c[1] : c[0]) + __shfl_xor_sync(kAll, h4 ? c[0] : c[1], 4);
  e += __shfl_xor_sync(kAll, e, 2);
  return e + __shfl_xor_sync(kAll, e, 1);
}
