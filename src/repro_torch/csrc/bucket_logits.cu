// bucket_logits: [B, d] queries x [S, P, d] slabs x int32 [B, L] slab ids
// -> fp32 [B, L, P] logits, out[b, l, p] = sum_i q[b, i] * w[s, p, i] with
// s = slab_ids[b, l], accumulated in fp32.
//
// Replaces the TPU kernel src/repro/kernels/bucket_logits/kernel.py
// (bucket_logits_pallas / _kernel).  There the grid step (b, l) gets slab
// slab_ids[b, l] through a scalar-prefetched BlockSpec and runs a [1, d] @
// [d, P] MXU product.
//
// Bound on the H100: slab bytes.  A (b, l) reads one [P, d] slab, 417 KB
// in fp32 at Delicious-200K (P = 808, d = 129), against 2*P*d = 0.21 MFLOP;
// at 3.35 TB/s and 67 TFLOP/s fp32 the bytes dominate.  Every slot row is
// read, empty ones too: the op takes no ids, and an empty slot is a zero
// row whose logit is 0, as in the plain version.  Queries of a batch share
// slabs (256 Delicious queries hit ~190 of 512), and the bound counts each
// distinct slab once.
//
// The first port gave one block to each (b, l), 8 warps with 4 rows of
// loads in flight each: at B = 1 one SM walked the whole slab while the
// others idled, at B = 256 two blocks an SM kept too few bytes in flight
// to cover the memory's latency, and each query read its slab again.
// This design:
//   * splits each (b, l)'s P rows over `splits` blocks of `block_rows`
//     rows; the wrapper picks them from B*L*P so that the grid covers the
//     SMs at B = 1 as at B = 256 (kernels/bucket_logits/ops.py,
//     bucket_logits_plan, which passes the plan to the launch);
//   * reads a slab once for up to kMaxGroup queries: the (b, l)s on one
//     slab are cut into tiles, and only the block of a tile's first (b, l)
//     streams the rows, for the whole tile (below);
//   * streams a block's rows through shared memory with bulk async copies
//     (bulk_copy.cuh), as lss_topk.cu does: each warp owns a ring of
//     kStages chunks of `rows` rows (~4 KB) and takes every warps-th chunk
//     of the block, copying the next while it dots the current one;
//     chunks are rounded out to 16 B at both ends (rows of d = 129 are
//     not 16-byte aligned) and read at their offset;
//   * dots 8 rows a warp at once against every query of the tile, lanes
//     across d, each row element loaded once into registers (dot_rows),
//     and sums each query's 8 with a transposed shuffle reduction
//     (warp_sum8).
// d need not be a multiple of 32 or of 4: lanes past d add nothing, and
// nothing is padded (the TPU's lane padding does not apply).
//
// A slab id outside [0, S) reads nothing and gives NaN logits for that
// (b, l): the wrapper does not check the ids on the host, since that would
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "bulk_copy.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kStages = 2;                // chunks in a warp's ring
constexpr int kRowsAtOnce = 8;            // rows a warp dots together
constexpr int kMaxGroup = 4;              // queries a block serves, at most
constexpr int kLoads = 4;                 // loads a thread keeps in flight
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSmemLimit = 232448;        // shared memory an H100 block can use

template <typename T>
__device__ __forceinline__ float widen(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// The logits of n staged rows (buf, row-major [n, d]) against the
// n_members <= G queries qs [n_members, d], 8 rows at a time: each lane
// loads its elements of the 8 rows once and keeps G x 8 partials, then
// warp_sum8 reduces each query's 8.  Lanes past d add nothing.
template <int G, typename TW>
__device__ __forceinline__ void dot_rows(
    const float* __restrict__ qs, int n_members, const TW* __restrict__ buf,
    int n, int d, int lane, float* __restrict__ out,
    const int* __restrict__ member, int cap, int r0) {
  for (int j0 = 0; j0 < n; j0 += kRowsAtOnce) {
    float acc[G][kRowsAtOnce];
#pragma unroll
    for (int m = 0; m < G; ++m)
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) acc[m][u] = 0.f;
    for (int i = lane; i < d; i += 32) {
      float wv[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u)
        wv[u] = j0 + u < n ? widen(buf[(j0 + u) * d + i]) : 0.f;
#pragma unroll
      for (int m = 0; m < G; ++m) {
        if (m < n_members) {                 // warp-uniform
          const float qi = qs[m * d + i];
#pragma unroll
          for (int u = 0; u < kRowsAtOnce; ++u)
            acc[m][u] = fmaf(qi, wv[u], acc[m][u]);
        }
      }
    }
    const int u = (lane >> 2) & 7;
#pragma unroll
    for (int m = 0; m < G; ++m) {
      if (m < n_members) {
        const float v = warp_sum8(acc[m], lane);
        if ((lane & 3) == 0 && j0 + u < n)
          out[static_cast<size_t>(member[m]) * cap + r0 + j0 + u] = v;
      }
    }
  }
}

// Block x serves rows [r_begin, r_end) of the slab s of (b, l) =
// divmod(x / splits, L), r_begin = (x % splits) * block_rows.  Where the
// plan gives n_ids > 0, the block first reads all n_ids = B*L slab ids:
// the (b, l)s on slab s form a group in (b, l) order, cut into tiles of
// `group` (<= kMaxGroup).  Only the block of a tile's first (b, l) streams
// the rows; it dots them with every query of the tile, and the others
// return.  So a slab is read once per tile, not once per query.
//
// Shared memory: the warps' mbarriers [warps][kStages], their rings
// [warps][kStages][stage], the tile's queries [group][d] widened to fp32,
// the slab ids [n_ids], the tile's (b, l)s [group] and 2 counters.
template <typename TQ, typename TW>
__global__ void __launch_bounds__(kMaxWarps * 32) bucket_logits_kernel(
    const TQ* __restrict__ q, const TW* __restrict__ w,
    const int* __restrict__ slab_ids, float* __restrict__ out, int n_tables,
    int n_slabs, int cap, int d, int rows, int stage, int block_rows,
    int splits, int n_ids, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bl = blockIdx.x / splits;       // b * L + l
  const int r_begin = (blockIdx.x - bl * splits) * block_rows;
  const int r_end = min(cap, r_begin + block_rows);
  const int s = slab_ids[bl];               // the same for the whole block
  if (s < 0 || s >= n_slabs) {
    float* o = out + static_cast<size_t>(bl) * cap;
    for (int r = r_begin + tid; r < r_end; r += blockDim.x)
      o[r] = CUDART_NAN_F;
    return;
  }
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + 8 * kStages * warps;
  float* qs = reinterpret_cast<float*>(
      ring + static_cast<size_t>(kStages) * warps * stage);
  int* sid = reinterpret_cast<int*>(qs + group * d);
  int* member = sid + n_ids;                // the tile's (b, l)s
  int* count = member + group;              // [0] rank of bl, [1] tile size
  if (tid == 0) {
    for (int i = 0; i < warps * kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    count[0] = 0;
    count[1] = 1;
    member[0] = bl;
  }
  for (int e0 = tid; e0 < n_ids; e0 += blockDim.x * kLoads) {
    int v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < n_ids ? slab_ids[e] : -1;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n_ids) sid[e] = v[u];
    }
  }
  __syncthreads();
  if (n_ids > 0) {
    // the rank of bl in its group: the (b, l)s before it on slab s
    int before = 0;
    for (int e = tid; e < bl; e += blockDim.x) before += sid[e] == s;
    before = __reduce_add_sync(kFull, before);
    if (lane == 0 && before) atomicAdd(&count[0], before);
    if (warp == 0) {                        // bl's tile, if bl leads it
      int found = 0;
      for (int e0 = bl; e0 < n_ids && found < group; e0 += 32) {
        const int e = e0 + lane;
        const bool hit = e < n_ids && sid[e] == s;
        const unsigned ballot = __ballot_sync(kFull, hit);
        const int pos = found + __popc(ballot & ((1u << lane) - 1));
        if (hit && pos < group) member[pos] = e;
        found += __popc(ballot);
      }
      if (lane == 0) count[1] = min(found, group);
    }
    __syncthreads();
    if (count[0] % group != 0) return;      // another block serves bl
  }
  const int n_members = count[1];

  // this warp's chunks: n = warp + j * warps, j < mine; chunk n is rows
  // [r_begin + n * rows, + rows) of slab s, cut at r_end
  const int n_chunks = (r_end - r_begin + rows - 1) / rows;
  const int mine = warp < n_chunks ? (n_chunks - 1 - warp) / warps + 1 : 0;
  uint64_t* wbars = bars + warp * kStages;
  unsigned char* wring = ring + static_cast<size_t>(warp) * kStages * stage;
  const TW* slab = w + static_cast<size_t>(s) * cap * d;
  auto first_row = [&](int j) { return r_begin + (warp + j * warps) * rows; };
  auto n_rows = [&](int j) { return min(rows, r_end - first_row(j)); };
  auto fetch = [&](int j) {                  // lane 0 copies chunk j
    const BulkSpan sp = bulk_span(
        slab + static_cast<size_t>(first_row(j)) * d,
        static_cast<size_t>(n_rows(j)) * d * sizeof(TW));
    if (lane == 0) {
      if (sp.size == 0)                      // d = 0: nothing to copy
        mbar_arrive(&wbars[j % kStages]);
      else
        bulk_copy(wring + (j % kStages) * stage,
                  reinterpret_cast<const void*>(sp.lo), sp.size,
                  &wbars[j % kStages], j >= kStages);
    }
  };
  for (int j = 0; j < kStages - 1 && j < mine; ++j) fetch(j);
  for (int e0 = tid; e0 < n_members * d; e0 += blockDim.x * kLoads) {
    float v[kLoads];                         // the tile's queries
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, m = e / d;
      v[u] = e < n_members * d
                 ? widen(q[static_cast<size_t>(member[m] / n_tables) * d +
                           e - m * d])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n_members * d) qs[e] = v[u];
    }
  }
  __syncthreads();

  for (int j = 0; j < mine; ++j) {
    if (j + kStages - 1 < mine) fetch(j + kStages - 1);
    mbar_wait(&wbars[j % kStages], (j / kStages) & 1);
    const int r0 = first_row(j), n = n_rows(j);
    const int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(slab + static_cast<size_t>(r0) * d) &
        15);
    const TW* buf =
        reinterpret_cast<const TW*>(wring + (j % kStages) * stage + off);
    if (n_members == 1)
      dot_rows<1>(qs, n_members, buf, n, d, lane, out, member, cap, r0);
    else if (n_members == 2)
      dot_rows<2>(qs, n_members, buf, n, d, lane, out, member, cap, r0);
    else
      dot_rows<kMaxGroup>(qs, n_members, buf, n, d, lane, out, member, cap,
                          r0);
    __syncwarp();                            // done with the stage
  }
}

template <typename TQ, typename TW>
int launch(const void* q, const void* w, const void* slab_ids, void* out,
           int n_queries, int n_tables, int n_slabs, int cap, int d,
           int rows, int stage, int block_rows, int splits, int warps,
           int n_ids, int group, int smem, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(d) * sizeof(TW);
  const long long need = 8LL * kStages * warps +
                         static_cast<long long>(kStages) * warps * stage +
                         4LL * group * d + 4LL * n_ids + 4LL * group + 8;
  if (rows < 1 || block_rows < 1 || splits < 1 || warps < 1 ||
      warps > kMaxWarps || stage % 16 != 0 || stage < rows * row_bytes + 32 ||
      static_cast<long long>(splits) * block_rows < cap || smem < need ||
      smem > kSmemLimit || group < 1 || group > kMaxGroup ||
      (n_ids != 0 && n_ids != static_cast<long long>(n_queries) * n_tables))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_logits_kernel<TQ, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(n_queries) * n_tables * (cap > 0 ? splits : 0);
  if (blocks > 0) {
    bucket_logits_kernel<TQ, TW>
        <<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
            static_cast<const TQ*>(q), static_cast<const TW*>(w),
            static_cast<const int*>(slab_ids), static_cast<float*>(out),
            n_tables, n_slabs, cap, d, rows, stage, block_rows, splits,
            n_ids, group);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_bf16 / w_bf16: 0 = fp32, 1 = bf16.  The plan (rows, stage, block_rows,
// splits, warps; n_ids: B*L, or 0 to serve each (b, l) alone; group: the
// queries a block serves, at most; smem) is the wrapper's
// (kernels/bucket_logits/ops.py, bucket_logits_plan); one that does not
// cover the rows or fit the shared memory is refused with
// cudaErrorInvalidValue.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int bucket_logits_launch(const void* q, const void* w, const void* slab_ids,
                         void* out, int n_queries, int n_tables, int n_slabs,
                         int cap, int d, int q_bf16, int w_bf16, int rows,
                         int stage, int block_rows, int splits, int warps,
                         int n_ids, int group, int smem, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define BUCKET_LOGITS_LAUNCH(TQ, TW)                                       \
  return launch<TQ, TW>(q, w, slab_ids, out, n_queries, n_tables, n_slabs, \
                        cap, d, rows, stage, block_rows, splits, warps,    \
                        n_ids, group, smem, st)
  if (!q_bf16 && !w_bf16) BUCKET_LOGITS_LAUNCH(float, float);
  if (!q_bf16 && w_bf16) BUCKET_LOGITS_LAUNCH(float, bf16);
  if (q_bf16 && !w_bf16) BUCKET_LOGITS_LAUNCH(bf16, float);
  BUCKET_LOGITS_LAUNCH(bf16, bf16);
#undef BUCKET_LOGITS_LAUNCH
}

const char* bucket_logits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
