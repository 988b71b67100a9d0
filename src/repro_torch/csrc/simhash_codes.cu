// simhash_codes: [B, d] rows x [d, K*L] hyperplanes -> int32 [B, L] codes.
//
// Replaces the TPU kernel src/repro/kernels/simhash_codes/kernel.py
// (simhash_codes_pallas / _kernel), which computes the scores as one MXU
// product and packs the bits with a second product against a constant
// [K*L, L] matrix.  Here one warp takes each (row, table) pair: its K dot
// products in fp32, lanes across d with a shuffle reduction, and the bits
// packed with shifts and ORs (simhash.cuh) — no pack matrix.
//
// Bound on the H100: the input read.  The work is 2*B*d*K*L flops
// (2.4 MFLOP at B=1024, d=129, K*L=9) against B*d*4 bytes of rows
// (528 KB); both are well under a microsecond, so at the serving path's
// shapes the kernel is bound by latency: the dependent chain of each
// hash and the launch.  Design: a block of 8 warps stages theta,
// transposed (d*K*L*4 B, 4.6 KB at Delicious), and a tile of kRows rows
// in shared memory with coalesced loads, so every row byte is read from
// device memory once and theta once per block; a warp per (row, table)
// keeps each chain at ~d/32 fmas per bit, and kRows = 8 gives B/8
// blocks to spread over the SMs.
//
// The caller passes rows already unit-normalised (core/lss.py does so in
// retrieve), as for the TPU kernel.
#include <cuda_runtime.h>

#include "simhash.cuh"

namespace {

constexpr int kRows = 8;       // rows per block
constexpr int kThreads = 256;  // 8 warps

__global__ void simhash_codes_kernel(const float* __restrict__ x,
                                     const float* __restrict__ theta,
                                     int* __restrict__ out, int n_rows, int d,
                                     int k_bits, int n_tables) {
  extern __shared__ float smem[];
  const int kl = k_bits * n_tables;
  float* th = smem;              // [kl, d]: theta transposed
  float* xs = smem + d * kl;     // [kRows, d]
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_theta_transposed(theta, th, d, kl);
  const float* xg = x + static_cast<size_t>(row0) * d;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) xs[i] = xg[i];
  __syncthreads();
  for (int p = warp; p < rows * n_tables; p += kThreads / 32) {
    const int r = p / n_tables, t = p % n_tables;
    const int code = simhash_table_code(xs + r * d, th, d, k_bits, t, lane);
    if (lane == 0) out[static_cast<size_t>(row0 + r) * n_tables + t] = code;
  }
}

// Dynamic shared memory one launch needs: theta + a tile of rows.  A
// size above the device's limit makes cudaFuncSetAttribute fail, and the
// launch entry returns that error.
int smem_bytes(int d, int k_bits, int n_tables) {
  return 4 * (d * k_bits * n_tables + kRows * d);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the first CUDA error (0 = launched).
int simhash_codes_launch(const void* x, const void* theta, void* out,
                         int n_rows, int d, int k_bits, int n_tables,
                         void* stream) {
  const int smem = smem_bytes(d, k_bits, n_tables);
  cudaError_t err = cudaFuncSetAttribute(
      simhash_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rows + kRows - 1) / kRows;
  if (blocks > 0) {
    simhash_codes_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(theta),
        static_cast<int*>(out), n_rows, d, k_bits, n_tables);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* simhash_codes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
