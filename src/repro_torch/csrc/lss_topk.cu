// lss_topk: the fused LSS serving pass (paper Algorithm 2), one block per
// query:  hash -> fetch the L hit slabs -> logits -> first-occurrence
// dedup -> top-k.
//
// Replaces the TPU kernel src/repro/kernels/lss_topk/kernel.py
// (lss_topk_pallas / _make_kernel with the epilogues _topk_quadratic_row
// and _topk_bitonic_tile).  It computes the same function, not the same
// blocks: the TPU kernel runs a [Bq, d] query tile through [Bq, d]@[d, P]
// MXU products and keeps one row of each; here one block serves one
// query and a warp takes a few slab rows at a time.
//
// Bound on the H100: slab bytes.  A query reads L slabs of P rows of
// d elements (+ P int32 ids, + P fp32 scales for int8): 420,160 B at
// Delicious-200K in fp32 (L=1, P=808, d=129), against ~2*L*P*d flops.
// At 3.35 TB/s that is ~0.13 us a query before any L2 reuse; the flops
// are ~0.2 MFLOP, far below the fp32 rate.  Design for that bound:
//   * only the hit slabs are read, and a row whose id is -1 (an empty
//     slot, a zero row by construction) is not read at all: its logit is
//     masked by id either way;
//   * a warp reads a row with consecutive lanes on consecutive elements
//     (coalesced) and reads kRowsInFlight rows at once, and several
//     blocks share an SM (~20 KB of shared memory each at Delicious),
//     which keeps many rows in flight;
//   * bf16 and int8 storage are widened in registers, so they read 2x and
//     ~4x fewer slab bytes.
// Later work (TMA slab loads, wgmma, grouping queries that hit the same
// slab) is for a kernel made fast, not this first one.
//
// Stages (shared memory holds q, q/|q|, theta, and the C ids, logits and
// sort keys of this query):
//   1. load q_aug, normalise it exactly as kernel.py does
//      (q / max(sqrt(sum q^2), 1e-12)) and hash it with the device
//      function shared with simhash_codes.cu (a warp per table); slab t
//      is t*2^K + bucket_t.
//   2. warps walk the C = L*P slots, kRowsInFlight consecutive rows at a
//      time; each logit is a dot with the UNNORMALISED q_aug, as in
//      kernel.py; ids go to `cand` too.
//      int8 rows are widened and multiplied by the row's fp32 scale
//      element by element, the same op as dequantize_int8_rows.
//   3. dedup: one algorithm serves both values of the lss_topk.dedup
//      strategy (they give the same mask by contract): a bitonic sort of
//      64-bit (id, position) keys in shared memory, ids < 0 and the
//      padding up to the next power of two keyed 0xFFFFFFFF so they sort
//      last.  A key whose id differs from its left neighbour's is the
//      first occurrence of that id (the position breaks ties, so the
//      sort is stable).  Every other slot's logit becomes NEG_INF.  The
//      [C, C] compare of the quadratic strategy is never built.
//   4. top-k: k passes of a block-wide max, ties to the lowest original
//      position (the rule of lax.top_k); a picked slot drops to -inf.
//      A best logit <= NEG_INF/2 gives id -1.  sample = the mask's count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "simhash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;           // slab rows a warp reads at once
constexpr float kNegInf = -1e30f;          // repro.core.lss.NEG_INF
constexpr unsigned kNoId = 0xFFFFFFFFu;    // sort key of an invalid slot
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ inline int ceil_pow2(int c) {
  int n = 2;
  while (n < c) n <<= 1;
  return n;
}

__host__ __device__ inline int smem_bytes(int d, int k_bits, int n_tables,
                                          int cap) {
  const int c = n_tables * cap;
  // keys [n] u64 | q, qn [d] | theta^T [KL*d] | logits, ids [C] |
  // reduce scratch [32] f32 + [32] i32 | slab [L] | count
  return 8 * ceil_pow2(c) +
         4 * (2 * d + d * k_bits * n_tables + 2 * c + 64 + n_tables + 1);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Keep the larger value; on a tie, the lower position.
__device__ __forceinline__ void argmax_merge(float& v, int& p, float ov,
                                             int op) {
  if (ov > v || (ov == v && op < p)) {
    v = ov;
    p = op;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& p) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int op = __shfl_down_sync(kFull, p, off);
    argmax_merge(v, p, ov, op);
  }
}

template <typename T>
__device__ __forceinline__ float widen(T v, float scale) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return static_cast<float>(v) * scale;   // int8: dequantize_int8_rows
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lss_topk_kernel(
    const float* __restrict__ q_aug, const float* __restrict__ theta,
    const int* __restrict__ tids, const T* __restrict__ w,
    const float* __restrict__ scales, float* __restrict__ top_logits,
    int* __restrict__ top_ids, int* __restrict__ sample,
    int* __restrict__ cand, int d, int k_bits, int n_tables, int cap,
    int top_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kl = k_bits * n_tables;
  const int c = n_tables * cap;
  const int n = ceil_pow2(c);
  auto* keys = reinterpret_cast<unsigned long long*>(smem);
  float* q = reinterpret_cast<float*>(keys + n);
  float* qn = q + d;
  float* th = qn + d;
  float* logit = th + d * kl;
  int* ids = reinterpret_cast<int*>(logit + c);
  float* red_v = reinterpret_cast<float*>(ids + c);
  int* red_p = reinterpret_cast<int*>(red_v + 32);
  int* slab = red_p + 32;
  int* count = slab + n_tables;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- stage 1: normalise + hash ------------------------------------
  const float* qg = q_aug + static_cast<size_t>(b) * d;
  float ss = 0.f;
  for (int i = tid; i < d; i += kThreads) {
    const float v = qg[i];
    q[i] = v;
    ss = fmaf(v, v, ss);
  }
  load_theta_transposed(theta, th, d, kl);
  if (tid == 0) *count = 0;
  ss = warp_sum(ss);
  if (lane == 0) red_v[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? red_v[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red_p[0] = __float_as_int(fmaxf(sqrtf(s), 1e-12f));
  }
  __syncthreads();
  const float denom = __int_as_float(red_p[0]);
  for (int i = tid; i < d; i += kThreads) qn[i] = q[i] / denom;
  __syncthreads();
  for (int t = warp; t < n_tables; t += kWarps) {
    const int code = simhash_table_code(qn, th, d, k_bits, t, lane);
    if (lane == 0) slab[t] = (t << k_bits) + code;
  }
  __syncthreads();

  // ---- stage 2: slab logits, a warp on kRowsInFlight rows at once ---
  // The rows' loads are independent, so a warp keeps that many in flight
  // instead of waiting on one row's id, then its elements, then the sum.
  for (int r0 = warp * kRowsInFlight; r0 < c;
       r0 += kWarps * kRowsInFlight) {
    int id[kRowsInFlight];
    size_t row[kRowsInFlight];
    float sc[kRowsInFlight], acc[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = r0 + u;
      id[u] = -1;
      row[u] = 0;
      sc[u] = 1.f;
      acc[u] = 0.f;
      if (r < c) {
        const int t = r / cap;
        row[u] = static_cast<size_t>(slab[t]) * cap + (r - t * cap);
        id[u] = tids[row[u]];
        if constexpr (std::is_same<T, int8_t>::value) sc[u] = scales[row[u]];
      }
    }
    for (int i = lane; i < d; i += 32) {
      const float qi = q[i];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (id[u] >= 0)      // warp-uniform: an empty slot is not read
          acc[u] = fmaf(qi, widen(w[row[u] * d + i], sc[u]), acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = r0 + u;
      acc[u] = warp_sum(acc[u]);
      if (lane == 0 && r < c) {
        logit[r] = acc[u];
        ids[r] = id[u];
        cand[static_cast<size_t>(b) * c + r] = id[u];
      }
    }
  }
  __syncthreads();

  // ---- stage 3: first-occurrence dedup (bitonic sort of (id, pos)) --
  for (int i = tid; i < n; i += kThreads) {
    const unsigned u = (i < c && ids[i] >= 0) ? static_cast<unsigned>(ids[i])
                                              : kNoId;
    keys[i] = (static_cast<unsigned long long>(u) << 32) |
              static_cast<unsigned>(i);
  }
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long lo = keys[i], hi = keys[ixj];
          if ((lo > hi) == ((i & k) == 0)) {
            keys[i] = hi;
            keys[ixj] = lo;
          }
        }
      }
      __syncthreads();
    }
  }
  int n_first = 0;
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long key = keys[i];
    const unsigned u = static_cast<unsigned>(key >> 32);
    const int pos = static_cast<int>(key & 0xFFFFFFFFull);
    const bool first =
        u != kNoId &&
        (i == 0 || static_cast<unsigned>(keys[i - 1] >> 32) != u);
    if (first) {
      ++n_first;
    } else if (pos < c) {
      logit[pos] = kNegInf;
    }
  }
  n_first = warp_sum(n_first);
  if (lane == 0 && n_first) atomicAdd(count, n_first);
  __syncthreads();

  // ---- stage 4: k passes of block-wide max --------------------------
  for (int kk = 0; kk < top_k; ++kk) {
    float bv = -CUDART_INF_F;
    int bp = INT_MAX;
    for (int i = tid; i < c; i += kThreads) argmax_merge(bv, bp, logit[i], i);
    warp_argmax(bv, bp);
    if (lane == 0) {
      red_v[warp] = bv;
      red_p[warp] = bp;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -CUDART_INF_F;
      bp = lane < kWarps ? red_p[lane] : INT_MAX;
      warp_argmax(bv, bp);
      if (lane == 0) {
        const size_t o = static_cast<size_t>(b) * top_k + kk;
        top_logits[o] = bv;
        top_ids[o] = bv > kNegInf / 2 ? ids[bp] : -1;
        logit[bp] = -CUDART_INF_F;
      }
    }
    __syncthreads();
  }
  if (tid == 0) sample[b] = *count;
}

template <typename T>
int launch(const void* q_aug, const void* theta, const void* tids,
           const void* w, const void* scales, void* top_logits,
           void* top_ids, void* sample, void* cand, int n_queries, int d,
           int k_bits, int n_tables, int cap, int top_k,
           cudaStream_t stream) {
  const int smem = smem_bytes(d, k_bits, n_tables, cap);
  cudaError_t err = cudaFuncSetAttribute(
      lss_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_queries > 0) {
    lss_topk_kernel<T><<<n_queries, kThreads, smem, stream>>>(
        static_cast<const float*>(q_aug), static_cast<const float*>(theta),
        static_cast<const int*>(tids), static_cast<const T*>(w),
        static_cast<const float*>(scales), static_cast<float*>(top_logits),
        static_cast<int*>(top_ids), static_cast<int*>(sample),
        static_cast<int*>(cand), d, k_bits, n_tables, cap, top_k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (bytes); ops.py mirrors it.
int lss_topk_smem_bytes(int d, int k_bits, int n_tables, int cap) {
  return smem_bytes(d, k_bits, n_tables, cap);
}

// storage: 0 = fp32, 1 = bf16, 2 = int8 (scales required).  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int lss_topk_launch(const void* q_aug, const void* theta, const void* tids,
                    const void* w, const void* scales, void* top_logits,
                    void* top_ids, void* sample, void* cand, int n_queries,
                    int d, int k_bits, int n_tables, int cap, int top_k,
                    int storage, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch<float>(q_aug, theta, tids, w, nullptr, top_logits,
                           top_ids, sample, cand, n_queries, d, k_bits,
                           n_tables, cap, top_k, s);
    case 1:
      return launch<__nv_bfloat16>(q_aug, theta, tids, w, nullptr,
                                   top_logits, top_ids, sample, cand,
                                   n_queries, d, k_bits, n_tables, cap,
                                   top_k, s);
    case 2:
      return launch<int8_t>(q_aug, theta, tids, w, scales, top_logits,
                            top_ids, sample, cand, n_queries, d, k_bits,
                            n_tables, cap, top_k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* lss_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
