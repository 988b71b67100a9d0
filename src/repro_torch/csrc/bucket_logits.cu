// bucket_logits: [B, d] queries x [S, P, d] slabs x int32 [B, L] slab ids
// -> fp32 [B, L, P] logits, out[b, l, p] = sum_i q[b, i] * w[s, p, i] with
// s = slab_ids[b, l], accumulated in fp32.
//
// Replaces the TPU kernel src/repro/kernels/bucket_logits/kernel.py
// (bucket_logits_pallas / _kernel).  There the grid step (b, l) gets slab
// slab_ids[b, l] through a scalar-prefetched BlockSpec and runs a [1, d] @
// [d, P] MXU product.  Here one block serves one (b, l) and loads its own
// slab id; the query row is staged in shared memory, widened to fp32; each
// warp takes kRowsInFlight slab rows at a time, lanes across d, and sums
// each row with a shuffle reduction (as stage 2 of lss_topk.cu does).  d
// need not be a multiple of 32 or of 4: lanes past d add nothing, and
// nothing is padded (the TPU's lane padding does not apply).
//
// Bound on the H100: slab bytes.  A (b, l) reads one [P, d] slab, 417 KB
// in fp32 at Delicious-200K (P = 808, d = 129), against 2*P*d = 0.21 MFLOP;
// at 3.35 TB/s and 67 TFLOP/s fp32 the bytes dominate.  Queries that hit
// the same slab read it again (from L2 when it is still there).  Every
// slot row is read, empty ones too: the op takes no ids, and an empty slot
// is a zero row whose logit is 0, as in the plain version.
//
// A slab id outside [0, S) reads nothing and gives NaN logits for that
// (b, l): the wrapper does not check the ids on the host, since that would
// synchronise.
//
// Later work, for a kernel made fast: group the queries that hit the same
// slab (one slab read, a small GEMM), and stage slabs in shared memory with
// cp.async or TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;   // slab rows a warp reads at once
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T>
__device__ __forceinline__ float widen(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename TQ, typename TW>
__global__ void __launch_bounds__(kThreads) bucket_logits_kernel(
    const TQ* __restrict__ q, const TW* __restrict__ w,
    const int* __restrict__ slab_ids, float* __restrict__ out, int n_tables,
    int n_slabs, int cap, int d) {
  extern __shared__ float qs[];   // [d], fp32
  const int bl = blockIdx.x;      // b * L + l
  const int b = bl / n_tables;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* o = out + static_cast<size_t>(bl) * cap;
  const int s = slab_ids[bl];     // the same for the whole block
  if (s < 0 || s >= n_slabs) {
    for (int p = tid; p < cap; p += kThreads) o[p] = CUDART_NAN_F;
    return;
  }
  const TQ* qg = q + static_cast<size_t>(b) * d;
  for (int i = tid; i < d; i += kThreads) qs[i] = widen(qg[i]);
  __syncthreads();

  const TW* slab = w + static_cast<size_t>(s) * cap * d;
  for (int r0 = warp * kRowsInFlight; r0 < cap;
       r0 += kWarps * kRowsInFlight) {
    float acc[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) acc[u] = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float qi = qs[i];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (r0 + u < cap)   // warp-uniform
          acc[u] = fmaf(qi, widen(slab[static_cast<size_t>(r0 + u) * d + i]),
                        acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      float v = acc[u];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(kFull, v, off);
      if (lane == 0 && r0 + u < cap) o[r0 + u] = v;
    }
  }
}

template <typename TQ, typename TW>
int launch(const void* q, const void* w, const void* slab_ids, void* out,
           int n_queries, int n_tables, int n_slabs, int cap, int d,
           cudaStream_t stream) {
  const int smem = 4 * d;
  cudaError_t err = cudaFuncSetAttribute(
      bucket_logits_kernel<TQ, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(n_queries) * n_tables;
  if (blocks > 0) {
    bucket_logits_kernel<TQ, TW>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            static_cast<const TQ*>(q), static_cast<const TW*>(w),
            static_cast<const int*>(slab_ids), static_cast<float*>(out),
            n_tables, n_slabs, cap, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_bf16 / w_bf16: 0 = fp32, 1 = bf16.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int bucket_logits_launch(const void* q, const void* w, const void* slab_ids,
                         void* out, int n_queries, int n_tables, int n_slabs,
                         int cap, int d, int q_bf16, int w_bf16,
                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (!q_bf16 && !w_bf16)
    return launch<float, float>(q, w, slab_ids, out, n_queries, n_tables,
                                n_slabs, cap, d, st);
  if (!q_bf16 && w_bf16)
    return launch<float, bf16>(q, w, slab_ids, out, n_queries, n_tables,
                               n_slabs, cap, d, st);
  if (q_bf16 && !w_bf16)
    return launch<bf16, float>(q, w, slab_ids, out, n_queries, n_tables,
                               n_slabs, cap, d, st);
  return launch<bf16, bf16>(q, w, slab_ids, out, n_queries, n_tables,
                            n_slabs, cap, d, st);
}

const char* bucket_logits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
