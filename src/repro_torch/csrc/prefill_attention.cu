// prefill_attention: one layer's causal attention over a whole prompt,
// q [B, S, N, H] against k, v [B, S, KV, H] -> [B, S, N, H], in one launch.
//
// Replaces no TPU kernel: the JAX package's prefill attention is plain jnp
// (src/repro/models/layers.py, attention_blockwise), a Python loop over
// query and KV chunks.  Eager on the H100, that loop issued ~25 ops for
// each (query chunk, KV chunk) pair: ~400 a layer at a 4,096-token prompt,
// with fp32 copies of K and V and fp32 score tiles of [N, 2,048, 512]
// written and read several times.  The forward was bound by the host's
// launches, and on the card by those tiles' bytes.
//
// Bound on the H100: at long S, the tensor cores (4 * N * H * S(S+1)/2
// flops; Qwen2-0.5B's layer at S = 4,096: 30 GFLOP, 0.030 ms at 989
// TFLOP/s, against 17 MB of q, k, v and out, 0.005 ms at 3.35 TB/s); at
// short S, the launch.
// This design:
//   * one launch a layer, no workspace, scores never in device memory;
//   * one block of 4 warps a (64-row query tile, query head, row); each
//     warp 16 rows.  A block takes one query head rather than packing the
//     r heads of a KV head into its rows: r = 7 (Qwen2-0.5B) fills no
//     power-of-two tile, and a layer's K and V (2 MB at S = 4,096) stay in
//     the 50 MB L2 for the r blocks that read them again;
//   * K and V tiles of 64 positions streamed through shared memory by
//     cp.async, double-buffered (the next tile lands while this one is
//     used), rows padded by 16 bytes so that ldmatrix reads no bank twice;
//   * q.k on the tensor cores (mma.sync m16n8k16, bf16 as stored, so every
//     product is exact, fp32 sums), times H^-0.5 in fp32;
//   * the online softmax in fp32 registers (FlashAttention-2's running
//     max and sum, exp and max as the plain version takes them);
//   * p.V with p at fp32 precision, as the plain version keeps it: p is
//     split into three bf16 terms, hi + mid + lo == p exactly (each term
//     takes the next 8 bits of p's 24), and each term's product with V is
//     exact on the tensor cores, summed in fp32.  Three products where a
//     bf16 p would need one: the price of the parent's precision;
//   * KV tiles wholly above the diagonal are never loaded (their share in
//     the plain version is exactly 0: exp(-1e30 - m) underflows); the
//     diagonal tile is masked;
//   * tiles at absolute positions and a fixed reduction order, so a row's
//     result depends only on the keys at or before it: the same bits at
//     any S that holds the row;
//   * query tiles launched longest first (the grid's slow axis counts
//     down), so the causal imbalance leaves no tail of long tiles.
// float32 inputs (the reduced configurations) take a plain kernel on the
// CUDA cores with the same tiling, grid and order: fp32 products and sums
// as the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // query rows a block
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int kF32Threads = 256;  // fp32 kernel: 4 threads a query row
constexpr int kMaxGroup = 16;     // query heads a KV head serves, at most
constexpr unsigned kAll = 0xFFFFFFFFu;

// The bf16 kernel's shared memory for a head size: two stages of a K and
// a V tile, each row padded by 8 elements (16 bytes).
template <int H>
struct Bf16Layout {
  static constexpr int kStride = H + 8;
  static constexpr int kTile = kBN * kStride;  // elements
  static constexpr int kSmem = 2 * 2 * kTile * static_cast<int>(sizeof(bf16));
  static_assert(H % 16 == 0, "whole k-steps of 16");
};

// The fp32 kernel's: the scaled q tile, K and V tiles, the tile's p.
template <int H>
struct F32Layout {
  static constexpr int kQStride = H + 1;  // odd: rows on distinct banks
  static constexpr int kPStride = kBN + 1;
  static constexpr int kSmem =
      (2 * kBM * kQStride + kBN * H + kBM * kPStride) * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // an invalid row copies 0 bytes and zero-fills the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (first, second) in one register, first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x == hi + mid + lo exactly, each a bf16 (x in fp32, 24 bits: each term
// takes the next 8, and each subtraction is exact by Sterbenz's lemma).
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16(x));
  const float r1 = x - hi;
  mid = __bfloat162float(__float2bfloat16(r1));
  lo = r1 - mid;
}

// Two fp32 values of one A-fragment register as three bf16x2 terms.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  float xh, xm, xl, yh, ym, yl;
  split3(x, xh, xm, xl);
  split3(y, yh, ym, yl);
  hi = pack_bf16(xh, yh);
  mid = pack_bf16(xm, ym);
  lo = pack_bf16(xl, yl);
}

template <int H>
__global__ void __launch_bounds__(kThreads) prefill_attn_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int seq, int n_heads,
    int kv_heads, float scale) {
  using Lay = Bf16Layout<H>;
  constexpr int kStride = Lay::kStride;
  constexpr int kKSteps = H / 16;  // q.k's depth in k-steps
  constexpr int kNB = H / 8;       // the output's 8-column blocks
  constexpr int kRowChunks = H / 8;  // 16-byte chunks a K or V row

  const int tile = gridDim.y - 1 - blockIdx.y;  // longest first
  const int b = blockIdx.x / n_heads, head = blockIdx.x % n_heads;
  const int kvh = head / (n_heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this thread's two query rows (of the warp's 16): r_lo and r_lo + 8
  const int r_lo = tile * kBM + warp * 16 + g, r_hi = r_lo + 8;

  const long long q_pos = static_cast<long long>(n_heads) * H;
  const long long kv_pos = static_cast<long long>(kv_heads) * H;
  const bf16* qb = q + (static_cast<long long>(b) * seq * n_heads + head) * H;
  const bf16* kb = k + (static_cast<long long>(b) * seq * kv_heads + kvh) * H;
  const bf16* vb = v + (static_cast<long long>(b) * seq * kv_heads + kvh) * H;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [stage][K, V][kBN][kStride]

  // KV tile j into stage st: positions past the prompt are zero-filled
  auto load_tile = [&](int j, int st) {
    bf16* kt = tiles + st * 2 * Lay::kTile;
    bf16* vt = kt + Lay::kTile;
    for (int c = threadIdx.x; c < kBN * kRowChunks; c += kThreads) {
      const int r = c / kRowChunks, col = c % kRowChunks * 8;
      const int pos = j * kBN + r;
      const bool ok = pos < seq;
      const long long at = (ok ? pos : 0) * kv_pos + col;
      cp_async16(kt + r * kStride + col, kb + at, ok);
      cp_async16(vt + r * kStride + col, vb + at, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // the warp's q rows as A fragments, in bf16 as stored (rows past the
  // prompt are zero)
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int c0 = kk * 16 + 2 * t4;
    const uint32_t* lo_row =
        reinterpret_cast<const uint32_t*>(qb + r_lo * q_pos + c0);
    const uint32_t* hi_row =
        reinterpret_cast<const uint32_t*>(qb + r_hi * q_pos + c0);
    qa[kk][0] = r_lo < seq ? lo_row[0] : 0u;
    qa[kk][1] = r_hi < seq ? hi_row[0] : 0u;
    qa[kk][2] = r_lo < seq ? lo_row[4] : 0u;  // columns + 8
    qa[kk][3] = r_hi < seq ? hi_row[4] : 0u;
  }

  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows r_lo, r_hi
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sum

  // ldmatrix: lane l gives the row address of matrix l / 8
  const int mat = lane / 8, mrow = lane % 8;

  for (int j = 0; j <= tile; ++j) {
    if (j < tile) {
      load_tile(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = tiles + (j & 1) * 2 * Lay::kTile;
    const bf16* vt = kt + Lay::kTile;

    // ---- scores: s[nb] is keys nb * 8 .. nb * 8 + 7 of the tile
    float s[kBN / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kBN / 8; nb += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + (nb * 8 + (mat >> 1) * 8 + mrow) * kStride +
                        kk * 16 + (mat & 1) * 8);
        mma_bf16(s[nb], qa[kk], kf[0], kf[1]);
        mma_bf16(s[nb + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // ---- scale, the diagonal tile's mask, the running max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        if (j == tile) {
          const int key = j * kBN + nb * 8 + 2 * t4 + (e & 1);
          if (key > (e < 2 ? r_lo : r_hi)) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kAll, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kAll, mx[i], 2));
      // tile 0 holds key 0, which every row sees: the max is finite
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - m_run[e >> 1]);  // masked: 0
        s[nb][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }

    // ---- p . V: keys in k-steps of 16, p as three exact bf16 terms
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      uint32_t ph[4], pm[4], pl[4];
      split_pair(s[2 * ks][0], s[2 * ks][1], ph[0], pm[0], pl[0]);
      split_pair(s[2 * ks][2], s[2 * ks][3], ph[1], pm[1], pl[1]);
      split_pair(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pm[2], pl[2]);
      split_pair(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int nb = 0; nb < kNB; nb += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (ks * 16 + (mat & 1) * 8 + mrow) * kStride +
                              nb * 8 + (mat >> 1) * 8);
        mma_bf16(acc[nb], pl, vf[0], vf[1]);
        mma_bf16(acc[nb], pm, vf[0], vf[1]);
        mma_bf16(acc[nb], ph, vf[0], vf[1]);
        mma_bf16(acc[nb + 1], pl, vf[2], vf[3]);
        mma_bf16(acc[nb + 1], pm, vf[2], vf[3]);
        mma_bf16(acc[nb + 1], ph, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the stage is read: the next load may take it
  }

  // ---- the row sums over the quad, the output in bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(kAll, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(kAll, l_run[i], 2);
  }
  bf16* ob = out + (static_cast<long long>(b) * seq * n_heads + head) * H;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    const int col = nb * 8 + 2 * t4;
    if (r_lo < seq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_lo * q_pos + col) =
          __floats2bfloat162_rn(acc[nb][0] / l_run[0],
                                acc[nb][1] / l_run[0]);
    if (r_hi < seq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_hi * q_pos + col) =
          __floats2bfloat162_rn(acc[nb][2] / l_run[1],
                                acc[nb][3] / l_run[1]);
  }
}

// float32: thread t takes query row t / 4 and every 4th key and output
// column from t % 4; the same tiles, order and masking as the bf16 kernel.
template <int H>
__global__ void __launch_bounds__(kF32Threads) prefill_attn_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int seq,
    int n_heads, int kv_heads, float scale) {
  using Lay = F32Layout<H>;
  constexpr int kQS = Lay::kQStride, kPS = Lay::kPStride;
  constexpr int kKeys = kBN / 4, kCols = H / 4;  // a thread's

  const int tile = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / n_heads, head = blockIdx.x % n_heads;
  const int kvh = head / (n_heads / kv_heads);
  const int t = threadIdx.x, r = t / 4, c = t % 4;
  const int row = tile * kBM + r;

  const long long q_pos = static_cast<long long>(n_heads) * H;
  const long long kv_pos = static_cast<long long>(kv_heads) * H;
  const float* qb = q + (static_cast<long long>(b) * seq * n_heads + head) * H;
  const float* kb = k + (static_cast<long long>(b) * seq * kv_heads + kvh) * H;
  const float* vb = v + (static_cast<long long>(b) * seq * kv_heads + kvh) * H;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kBM][kQS], q * scale
  float* ks = qs + kBM * kQS;                   // [kBN][kQS]
  float* vs = ks + kBN * kQS;                   // [kBN][H]
  float* ps = vs + kBN * H;                     // [kBM][kPS]

  for (int i = t; i < kBM * H; i += kF32Threads) {
    const int rr = i / H, h = i % H, pos = tile * kBM + rr;
    qs[rr * kQS + h] = pos < seq ? qb[pos * q_pos + h] * scale : 0.f;
  }
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int j = 0; j <= tile; ++j) {
    __syncthreads();  // the last tile's readers are done
    for (int i = t; i < kBN * H; i += kF32Threads) {
      const int rr = i / H, h = i % H, pos = j * kBN + rr;
      const bool ok = pos < seq;
      ks[rr * kQS + h] = ok ? kb[pos * kv_pos + h] : 0.f;
      vs[rr * H + h] = ok ? vb[pos * kv_pos + h] : 0.f;
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.f;
    for (int h = 0; h < H; ++h) {
      const float qv = qs[r * kQS + h];
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        s[i] = fmaf(qv, ks[(c + 4 * i) * kQS + h], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if (j == tile && j * kBN + c + 4 * i > row) s[i] = -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float p = expf(s[i] - m_new);
      l_run += p;
      ps[r * kPS + c + 4 * i] = p;
    }
    __syncwarp();  // the row's p, from the quad's four lanes
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] *= alpha;
    for (int key = 0; key < kBN; ++key) {
      const float p = ps[r * kPS + key];
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        acc[e] = fmaf(p, vs[key * H + c + 4 * e], acc[e]);
    }
  }
  l_run += __shfl_xor_sync(kAll, l_run, 1);
  l_run += __shfl_xor_sync(kAll, l_run, 2);
  if (row < seq) {
    float* ob = out + ((static_cast<long long>(b) * seq + row) * n_heads +
                       head) * H;
#pragma unroll
    for (int e = 0; e < kCols; ++e) ob[c + 4 * e] = acc[e] / l_run;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int batch, seq, n_heads, kv_heads;
  float scale;
  cudaStream_t stream;
};

template <typename T, int H>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.batch * a.n_heads, (a.seq + kBM - 1) / kBM);
  if constexpr (sizeof(T) == 2) {
    auto* kernel = prefill_attn_bf16_kernel<H>;
    constexpr int smem = Bf16Layout<H>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.seq,
        a.n_heads, a.kv_heads, a.scale);
  } else {
    auto* kernel = prefill_attn_fp32_kernel<H>;
    constexpr int smem = F32Layout<H>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kF32Threads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.seq,
        a.n_heads, a.kv_heads, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch<T, 16>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the kernel on `stream`; returns the CUDA error (0 = launched).
// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).  q and out
// [B, S, N, H], k and v [B, S, KV, H], contiguous and 16-byte aligned;
// scale multiplies q.k.  Shapes the kernel does not take are refused with
// cudaErrorInvalidValue.
int prefill_attention_launch(const void* q, const void* k, const void* v,
                             void* out, int dtype, int batch, int seq,
                             int n_heads, int kv_heads, int head_dim,
                             float scale, void* stream) {
  if (batch < 1 || seq < 1 || kv_heads < 1 || n_heads % kv_heads ||
      n_heads / kv_heads > kMaxGroup ||
      static_cast<long long>(batch) * n_heads > 2147483647LL ||
      (seq + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, batch, seq, n_heads, kv_heads, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0)
    err = by_head_dim<float>(head_dim, a);
  else if (dtype == 1)
    err = by_head_dim<bf16>(head_dim, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* prefill_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
