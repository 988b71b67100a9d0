// simhash_codes: [B, d] rows x [d, K*L] hyperplanes -> int32 [B, L] codes.
//
// Replaces the TPU kernel src/repro/kernels/simhash_codes/kernel.py
// (simhash_codes_pallas / _kernel), which computes the scores as one MXU
// product and packs the bits with a second product against a constant
// [K*L, L] matrix.  Here one warp takes each (row, table) pair and packs
// the bits with shifts and ORs (simhash.cuh): no pack matrix.
//
// Bound on the H100: the input read.  The work is 2*B*d*K*L flops
// (2.4 MFLOP at B=1024, d=129, K*L=9) against B*d*4 bytes of rows
// (528 KB); both are well under a microsecond, so at the serving path's
// shapes the kernel is bound by latency: the launch, one trip to device
// memory for theta and the rows, and the dependent chain of each hash.
// The first port hashed a table's K bits one after another, each a
// lane-strided loop and a shuffle tree, so its time grew with K*L
// (~0.47 us a chained bit on the H100).  This design:
//   * hashes all K bits of a table in one pass over d: each lane keeps K
//     partials and the K shuffle trees run interleaved, 8 at a time
//     (simhash_table_code).  Each score is summed in the same order as
//     before and as lss_topk.cu's stage 1, so the bits are the same;
//   * loads theta as stored, coalesced, into shared memory, each row
//     padded to an odd stride so that the lanes' reads of one column hit
//     32 different banks;
//   * gives a block rows_per_block rows (the wrapper picks it, at most
//     kMaxRows, so that the grid covers the SMs at B = 256): a block
//     loads theta and its rows together, each thread kLoads loads at a
//     time, so one trip to device memory (two at K*L = 32).
//
// Where theta and the block's rows do not fit in shared memory together
// (d = 7,169 at K*L = 8: 287 KB), the wrapper plans a tiled launch
// (`tile` > 0): simhash_codes_tiled_kernel feeds theta and the rows in
// d-tiles of `tile` elements, a multiple of 32, through shared memory,
// and each warp keeps its (row, table) pair's K partials in registers
// across the tiles.  Each lane sums its elements in the same order as
// in one pass over d, so the codes are those of the untiled kernel.
//
// The caller passes rows already unit-normalised (core/lss.py does so in
// retrieve), as for the TPU kernel.
#include <cuda_runtime.h>

#include "simhash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;        // rows per block, at most
constexpr int kLoads = 16;         // loads a thread keeps in flight
constexpr int kSmemLimit = 232448; // shared memory an H100 block can use

// theta [d, kl] as stored -> th, row i at th + i * (kl + pad); then the
// block's rows, n_x floats, -> xs.  One index space over both, so a thread
// keeps kLoads independent loads in flight from the start.
__device__ __forceinline__ void stage_inputs(
    const float* __restrict__ theta, float* __restrict__ th, int n_th,
    int kl, int pad, const float* __restrict__ xg, float* __restrict__ xs,
    int n_x) {
  const int n = n_th + n_x;
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < n_th ? theta[e] : (e < n ? xg[e - n_th] : 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n_th)
        th[e + e / kl * pad] = v[u];
      else if (e < n)
        xs[e - n_th] = v[u];
    }
  }
}

template <int kMaxK>
__global__ void __launch_bounds__(kThreads) simhash_codes_kernel(
    const float* __restrict__ x, const float* __restrict__ theta,
    int* __restrict__ out, int n_rows, int d, int k_bits, int n_tables,
    int rows_per_block, int stride) {
  extern __shared__ float smem[];
  const int kl = k_bits * n_tables;
  float* th = smem;                  // [d, stride]: theta, rows padded
  float* xs = smem + d * stride;     // [rows, d]
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_inputs(theta, th, d * kl, kl, stride - kl,
               x + static_cast<size_t>(row0) * d, xs, rows * d);
  __syncthreads();
  for (int p = warp; p < rows * n_tables; p += kWarps) {
    const int r = p / n_tables, t = p - r * n_tables;
    const int code = simhash_table_code<kMaxK>(xs + r * d, th, stride, d,
                                               k_bits, t * k_bits, lane);
    if (lane == 0) out[static_cast<size_t>(row0 + r) * n_tables + t] = code;
  }
}

// theta and the block's rows fed in d-tiles of `tile` (a multiple of 32)
// elements: theta's rows [i0, i0 + tile) -> th, each padded to `stride`;
// the rows' elements [i0, i0 + tile) -> xs [rows][tile].  Warps take the
// block's (row, table) pairs kWarps at a time (one pass over d each), and
// a warp keeps its pair's partials across the tiles.
template <int kMaxK>
__global__ void __launch_bounds__(kThreads) simhash_codes_tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ theta,
    int* __restrict__ out, int n_rows, int d, int k_bits, int n_tables,
    int rows_per_block, int stride, int tile) {
  extern __shared__ float smem[];
  const int kl = k_bits * n_tables;
  float* th = smem;                  // [tile, stride]
  float* xs = smem + tile * stride;  // [rows, tile]
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = rows * n_tables;
  for (int p0 = 0; p0 < pairs; p0 += kWarps) {   // block-uniform
    const int p = p0 + warp;                     // warp-uniform
    const int r = p / n_tables, t = p - r * n_tables;
    float acc[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) acc[j] = 0.f;
    for (int i0 = 0; i0 < d; i0 += tile) {
      const int td = min(tile, d - i0);
      __syncthreads();                           // the last tile is used
      const float* tg = theta + static_cast<size_t>(i0) * kl;
      for (int e = threadIdx.x; e < td * kl; e += kThreads)
        th[e + e / kl * (stride - kl)] = tg[e];
      for (int e = threadIdx.x; e < rows * td; e += kThreads) {
        const int rr = e / td, c = e - rr * td;
        xs[rr * tile + c] = x[static_cast<size_t>(row0 + rr) * d + i0 + c];
      }
      __syncthreads();
      if (p < pairs)
        simhash_accumulate<kMaxK>(xs + r * tile, th, stride, td, k_bits,
                                  t * k_bits, lane, acc);
    }
    if (p < pairs) {
      const int code = simhash_code<kMaxK>(acc, k_bits, lane);
      if (lane == 0) out[static_cast<size_t>(row0 + r) * n_tables + t] = code;
    }
  }
}

template <int kMaxK>
int launch(const float* x, const float* theta, int* out, int n_rows, int d,
           int k_bits, int n_tables, int rows_per_block, int stride,
           int tile, int smem, cudaStream_t stream) {
  cudaError_t err =
      tile > 0 ? cudaFuncSetAttribute(
                     simhash_codes_tiled_kernel<kMaxK>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
               : cudaFuncSetAttribute(
                     simhash_codes_kernel<kMaxK>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0 && tile > 0) {
    simhash_codes_tiled_kernel<kMaxK><<<blocks, kThreads, smem, stream>>>(
        x, theta, out, n_rows, d, k_bits, n_tables, rows_per_block, stride,
        tile);
  } else if (blocks > 0) {
    simhash_codes_kernel<kMaxK><<<blocks, kThreads, smem, stream>>>(
        x, theta, out, n_rows, d, k_bits, n_tables, rows_per_block, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the first CUDA error (0 = launched).  The
// plan (rows_per_block, stride, tile, smem) is the wrapper's
// (kernels/simhash_codes/ops.py, simhash_codes_plan; tile 0: theta and
// the rows whole in shared memory); a plan that does not fit these shapes
// is refused with cudaErrorInvalidValue.
int simhash_codes_launch(const void* x, const void* theta, void* out,
                         int n_rows, int d, int k_bits, int n_tables,
                         int rows_per_block, int stride, int tile, int smem,
                         void* stream) {
  const long long kl = static_cast<long long>(k_bits) * n_tables;
  const long long width = tile > 0 ? tile : d;
  const long long need = 4LL * width * stride + 4LL * rows_per_block * width;
  if (k_bits < 1 || k_bits > 30 || n_tables < 1 || rows_per_block < 1 ||
      rows_per_block > kMaxRows || stride < kl || tile < 0 || tile % 32 ||
      smem < need || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* tf = static_cast<const float*>(theta);
  auto* o = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (k_bits <= 8)
    return launch<8>(xf, tf, o, n_rows, d, k_bits, n_tables, rows_per_block,
                     stride, tile, smem, st);
  if (k_bits <= 16)
    return launch<16>(xf, tf, o, n_rows, d, k_bits, n_tables, rows_per_block,
                      stride, tile, smem, st);
  return launch<32>(xf, tf, o, n_rows, d, k_bits, n_tables, rows_per_block,
                    stride, tile, smem, st);
}

const char* simhash_codes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
