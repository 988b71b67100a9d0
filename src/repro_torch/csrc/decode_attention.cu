// decode_attention: one decode step's attention for every row of a batch,
// read straight from a paged KV cache through its page table.
//
// Replaces no TPU kernel: the JAX package's decode attention is an einsum
// (src/repro/models/layers.py, attention_decode) over a view that
// decode_step_paged gathers to max_len.  On the H100 that plan moved the
// whole max_len-wide view several times a layer (the gather, an fp32 copy
// of each side, the einsums' permuted copies) however short a row was.
//
// Bound on the H100: bytes.  A row of context c reads c positions of K and
// V (2 * KV * H elements each) and does 4 * N * H flops a position, about
// r = N / KV flops a loaded element: below the ridge, so the first gain is
// to move fewer bytes.  But at r = 7 the fp32 FMAs on CUDA cores, with the
// bf16 conversions and the lane reductions, take about as long as the
// loads: at Qwen2-0.5B's step the kernel reaches 35-45% of its byte bound,
// and a variant that loads nothing takes nearly as long as the whole.
// The next gain is q.k on the tensor cores (bf16 inputs, exact products,
// fp32 sums).  This design:
//   * reads K and V once, in the cache's own type, through the page table,
//     and only the row's valid positions; nothing is widened in device
//     memory: each element is converted to fp32 in registers;
//   * splits a row's positions into kSplit-position splits at absolute
//     positions (flash-decoding's split-K; kSplit follows from the head
//     size and type alone: a 32 KB tile a side, at most 256 positions):
//     one block per (split, KV head, row), and a block whose split lies
//     past min(length + 1, max_len) exits at once, so the grid depends
//     only on B and max_len (one CUDA graph shape) while the work follows
//     the rows' own lengths;
//   * copies the split's K and V tiles into shared memory at the block's
//     start, one bulk (TMA) copy a position row a side, each thread its own
//     position's (its page looked up through the table), completing on one
//     mbarrier a side: every byte of the block is in flight at once, no
//     register holds a load, and the scores wait only for K, the p.V sums
//     for V;
//   * lets the R query heads of a KV head (R = r up to 8; r > 8: more
//     blocks) share every K and V element: TPP threads take one position,
//     each a 16-byte vector (narrower where H / TPP is small), and the R
//     dot products are reduced over the TPP lanes by a transposed
//     butterfly (RP - 1 + log2(TPP / RP) shuffles, RP = R rounded up to a
//     power of two, not R * log2(TPP));
//   * keeps every score, the split's softmax (max, sum) and the p.V sums in
//     fp32, the precision of the plain version; a second kernel merges the
//     splits' (max, sum, acc) in split order and writes q's type.
// A split's bounds are absolute positions, and every reduction runs in a
// fixed order, so a row's result is a function of that row's data alone:
// the same for a dense slab (an arena of one max_len page a row) as for a
// paged pool, at any batch, max_len or page size.
//
// The step's new K and V (position `length`) come from k_new and v_new,
// never from the arena, and the block that owns that position writes them
// to the row's page (page_table[b][length / P], offset length % P); a row
// at length == max_len writes nothing.  Each row writes only its own
// position, which no other row of the step reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks an SM: at most 85 registers a thread
constexpr int kMaxSplit = 256;     // positions a block attends over, at most
constexpr int kTileBytes = 32768;  // one side's tile in shared memory
constexpr int kMaxGroup = 8;       // query heads a block; r > 8: more blocks
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as Tensor.to
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// `bytes` more to land before `bar` completes its phase (one arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One row (a multiple of 16 bytes, both ends 16-byte aligned) into shared
// memory, counted against `bar`'s expected bytes.
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

constexpr int pow2_at_least(int r) {
  return r <= 1 ? 1 : 2 * pow2_at_least((r + 1) / 2);
}

// Positions a split covers for a head size and type: a 32 KB tile a side.
constexpr int split_positions(int row_bytes) {
  return kTileBytes / row_bytes < kMaxSplit ? kTileBytes / row_bytes
                                            : kMaxSplit;
}

// The shape of one (T, H, R) instantiation.
template <typename T, int H, int R>
struct Layout {
  static constexpr int kRp = pow2_at_least(R);          // R, padded
  static constexpr int kRowBytes = H * static_cast<int>(sizeof(T));
  static constexpr int kSplit = split_positions(kRowBytes);
  static constexpr int kChunks = kRowBytes / 16;        // 16 B a row
  static constexpr int kBase = 16 / static_cast<int>(sizeof(T));
  // threads a position: 16-byte vectors, but at least kRp lanes, so that
  // each query head's sum ends on a lane of its own
  static constexpr int kTpp = H / kBase > kRp ? H / kBase : kRp;
  static constexpr int kEpt = H / kTpp;           // elements a thread
  static constexpr int kGroups = kThreads / kTpp;  // positions at once
  static constexpr int kPpg = kSplit / kGroups;    // positions a group
  static constexpr int kTile = kSplit * kRowBytes;
  static constexpr int kRedBytes = kThreads * R * kEpt * 4;
  // K tile, V tile (the two hold the partial sums at the end), scores,
  // (max, sum) a head
  static constexpr int kSmem = 2 * kTile + R * kSplit * 4 + 2 * R * 4;
  static_assert(kSplit <= kThreads, "a position row a thread");
  static_assert(kTpp <= 32 && 32 % kTpp == 0, "a position within a warp");
  static_assert(kEpt >= 1 && kEpt * kTpp == H, "H split over the lanes");
  static_assert(kSplit % kGroups == 0, "whole positions a group");
  static_assert(kRedBytes <= 2 * kTile, "partial sums fit the tiles");
};

// Sum over a group of lanes (aligned, OFF * 2 of them at the first call)
// of v[0..N), scattered: after the N - 1 halving shuffles a lane holds one
// head's sum, head li / (TPP / N) for lane li of the group, which the
// remaining plain butterfly steps complete.  Every lane of the group ends
// with the same tree for its head.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&v)[kMaxGroup], int li) {
  if constexpr (N > 1) {
    constexpr int kHalf = N / 2;
    const bool upper = li & OFF;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(kAll, send, OFF);
    }
    reduce_scatter<kHalf, OFF / 2>(v, li);
  } else if constexpr (OFF >= 1) {
    v[0] += __shfl_xor_sync(kAll, v[0], OFF);
    reduce_scatter<1, OFF / 2>(v, li);
  }
}

template <typename T, int H, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_attn_split_kernel(
    const T* __restrict__ q, T* __restrict__ k_arena, T* __restrict__ v_arena,
    const int* __restrict__ table, const int* __restrict__ lengths,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml, int n_heads,
    int kv_heads, int groups, int page_tokens, int pages_per_slot,
    int max_len, int n_splits, float scale) {
  using Lay = Layout<T, H, R>;
  using V = Vec<T, Lay::kEpt>;
  constexpr int kRp = Lay::kRp, kTpp = Lay::kTpp, kEpt = Lay::kEpt;
  constexpr int kGroups = Lay::kGroups, kSplit = Lay::kSplit;
  constexpr int kChunks = Lay::kChunks;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / groups, hg = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int length = lengths[b];
  const int n_valid = min(length + 1, max_len);
  const int s0 = split * kSplit;
  if (s0 >= n_valid) return;  // the whole block: past the row's context
  const int s_end = min(s0 + kSplit, n_valid);
  const int r = n_heads / kv_heads;
  const int n0 = kvh * r + hg * R;      // the block's first query head
  const int r_blk = min(R, r - hg * R);
  const bool writer = hg == 0 && length < max_len;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[2];  // the K tile, the V tile
  T* k_tile = reinterpret_cast<T*>(smem);
  T* v_tile = reinterpret_cast<T*>(smem + Lay::kTile);
  float* sc = reinterpret_cast<float*>(smem + 2 * Lay::kTile);
  float* ml = sc + R * kSplit;

  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const unsigned bytes = static_cast<unsigned>(s_end - s0) * Lay::kRowBytes;
    mbar_expect(&bars[0], bytes);
    mbar_expect(&bars[1], bytes);
  }
  __syncthreads();

  // thread t: position s0 + t's rows, from its page (through the table),
  // or from k_new, v_new for the step's own position, which it also writes
  // to its page; a V row past the context is zeroed (p is 0 there)
  const long long new_row = (static_cast<long long>(b) * kv_heads + kvh) * H;
  if (t < kSplit) {
    const int pos = s0 + t;
    if (pos < s_end) {
      const T* k_src = k_new + new_row;
      const T* v_src = v_new + new_row;
      if (pos != length || writer) {
        const long long page =
            table[static_cast<long long>(b) * pages_per_slot +
                  pos / page_tokens];
        const long long at =
            ((page * page_tokens + pos % page_tokens) * kv_heads + kvh) * H;
        if (pos != length) {
          k_src = k_arena + at;
          v_src = v_arena + at;
        } else {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int e = c * (16 / static_cast<int>(sizeof(T)));
            *reinterpret_cast<uint4*>(k_arena + at + e) =
                *reinterpret_cast<const uint4*>(k_src + e);
            *reinterpret_cast<uint4*>(v_arena + at + e) =
                *reinterpret_cast<const uint4*>(v_src + e);
          }
        }
      }
      bulk_row(k_tile + t * H, k_src, Lay::kRowBytes, &bars[0]);
      bulk_row(v_tile + t * H, v_src, Lay::kRowBytes, &bars[1]);
    } else {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        reinterpret_cast<uint4*>(v_tile + t * H)[c] = make_uint4(0, 0, 0, 0);
    }
  }

  const int g = t / kTpp, li = t % kTpp;
  // this lane's slice of the block's query heads, scaled as the plain
  // version scales them (fp32 q times fp32 scale); heads past the
  // block's own are zero
  float qs[R][kEpt];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j < r_blk) {
      const V qv = *reinterpret_cast<const V*>(
          q + (static_cast<long long>(b) * n_heads + n0 + j) * H + li * kEpt);
#pragma unroll
      for (int e = 0; e < kEpt; ++e) qs[j][e] = to_float(qv.v[e]) * scale;
    } else {
#pragma unroll
      for (int e = 0; e < kEpt; ++e) qs[j][e] = 0.f;
    }
  }
  mbar_wait(&bars[0], 0);

  // ---- scores: q . k for every position of the split -> sc[j][pos]
#pragma unroll 2
  for (int i = 0; i < Lay::kPpg; ++i) {
    const int p = g + kGroups * i;
    const V kv = *reinterpret_cast<const V*>(k_tile + p * H + li * kEpt);
    float kf[kEpt];
#pragma unroll
    for (int e = 0; e < kEpt; ++e) kf[e] = to_float(kv.v[e]);
    float part[kMaxGroup];
#pragma unroll
    for (int j = 0; j < kRp; ++j) {
      float s = 0.f;
      if (j < R) {
#pragma unroll
        for (int e = 0; e < kEpt; ++e) s = fmaf(qs[j][e], kf[e], s);
      }
      part[j] = s;
    }
    reduce_scatter<kRp, kTpp / 2>(part, li);
    const int j = li / (kTpp / kRp);
    if (li % (kTpp / kRp) == 0 && j < R)
      sc[j * kSplit + p] = s0 + p < s_end ? part[0] : -INFINITY;
  }
  __syncthreads();

  // ---- the split's softmax: max, exp and sum of each head's scores
  const int warp = t / 32, lane = t % 32;
  for (int j = warp; j < R; j += kWarps) {
    float x[kSplit / 32];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kSplit / 32; ++k) {
      x[k] = sc[j * kSplit + lane + 32 * k];
      m = fmaxf(m, x[k]);
    }
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < kSplit / 32; ++k) {
      x[k] = expf(x[k] - m);
      l += x[k];
      sc[j * kSplit + lane + 32 * k] = x[k];
    }
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) l += __shfl_xor_sync(kAll, l, o);
    if (lane == 0) {
      ml[2 * j] = m;
      ml[2 * j + 1] = l;
    }
  }
  mbar_wait(&bars[1], 0);
  __syncthreads();  // the scores' exps, and the zeroed V rows

  // ---- p . V: each thread its slice of every head, over its positions
  float acc[R][kEpt];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < kEpt; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int i = 0; i < Lay::kPpg; ++i) {
    const int p = g + kGroups * i;
    const V vv = *reinterpret_cast<const V*>(v_tile + p * H + li * kEpt);
    float vf[kEpt];
#pragma unroll
    for (int e = 0; e < kEpt; ++e) vf[e] = to_float(vv.v[e]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float pj = sc[j * kSplit + p];
#pragma unroll
      for (int e = 0; e < kEpt; ++e) acc[j][e] = fmaf(pj, vf[e], acc[j][e]);
    }
  }
  __syncthreads();  // the tiles are read: they take the partial sums

  // each group's sums, laid out so that a quarter warp's float4 stores
  // (one group's lanes) fill 32 consecutive words: (group, head, the
  // lane's 4-element chunk, lane, element)
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kQuads = kEpt % 4 == 0 ? kEpt / 4 : 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if constexpr (kQuads > 0) {
#pragma unroll
      for (int c = 0; c < kQuads; ++c)
        *reinterpret_cast<float4*>(
            red + ((g * R + j) * kQuads + c) * kTpp * 4 + li * 4) =
            make_float4(acc[j][4 * c], acc[j][4 * c + 1], acc[j][4 * c + 2],
                        acc[j][4 * c + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < kEpt; ++e)
        red[(g * R + j) * H + li * kEpt + e] = acc[j][e];
    }
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(b) * n_heads + n0;
  for (int o = t; o < r_blk * H; o += kThreads) {
    const int j = o / H, h = o % H;
    const int at = kQuads > 0 ? (j * kQuads + h % kEpt / 4) * kTpp * 4 +
                                    h / kEpt * 4 + h % 4
                              : o;
    float s = 0.f;
#pragma unroll 8
    for (int gg = 0; gg < kGroups; ++gg) s += red[gg * R * H + at];
    ws_acc[((row0 + j) * n_splits + split) * H + h] = s;
  }
  if (t < r_blk) {
    const long long at = ((row0 + t) * n_splits + split) * 2;
    ws_ml[at] = ml[2 * t];
    ws_ml[at + 1] = ml[2 * t + 1];
  }
}

// One warp a (row, query head): the splits' (max, sum, acc) merged and
// divided, written in T.  Lane s reads split s's (max, sum) (and s + 32,
// ...), the max and the weighted sum are warp butterflies, and each lane
// sums its H / 32 outputs over the splits in split order, every split's
// weight broadcast from the lane that read it; a fixed order throughout.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) decode_attn_merge_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    const int* __restrict__ lengths, T* __restrict__ out, int batch,
    int n_heads, int max_len, int n_splits, int split) {
  constexpr int kPer = H < 32 ? 1 : H / 32;  // outputs a lane
  const int bn = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (bn >= batch * n_heads) return;
  const int b = bn / n_heads;
  const int n_valid = min(lengths[b] + 1, max_len);
  const int ns = (n_valid + split - 1) / split;
  const float* ml = ws_ml + static_cast<long long>(bn) * n_splits * 2;
  const float* acc = ws_acc + static_cast<long long>(bn) * n_splits * H;
  float m = -INFINITY;
  for (int s = lane; s < ns; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
  float den = 0.f;
  for (int s = lane; s < ns; s += 32)
    den += expf(ml[2 * s] - m) * ml[2 * s + 1];
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) den += __shfl_xor_sync(kAll, den, o);
  const bool active = lane < H;
  float o[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) o[k] = 0.f;
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int mine = s0 + lane;
    const float w = mine < ns ? expf(ml[2 * mine] - m) : 0.f;
    const int count = min(32, ns - s0);
#pragma unroll 8
    for (int u = 0; u < count; ++u) {
      const float wu = __shfl_sync(kAll, w, u);
      const float* row = acc + static_cast<long long>(s0 + u) * H + lane;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (active) o[k] = fmaf(wu, row[32 * k], o[k]);
    }
  }
  if (active) {
    T* dst = out + static_cast<long long>(bn) * H + lane;
#pragma unroll
    for (int k = 0; k < kPer; ++k) dst[32 * k] = from_float<T>(o[k] / den);
  }
}

struct Args {
  const void* q;
  void* k_arena;
  void* v_arena;
  const int* table;
  const int* lengths;
  const void* k_new;
  const void* v_new;
  float* ws_acc;
  float* ws_ml;
  void* out;
  int batch, n_heads, kv_heads, groups, page_tokens, pages_per_slot,
      max_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int H, int R>
cudaError_t launch(const Args& a) {
  using Lay = Layout<T, H, R>;
  const int n_splits = (a.max_len + Lay::kSplit - 1) / Lay::kSplit;
  auto* split = decode_attn_split_kernel<T, H, R>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, a.kv_heads * a.groups, a.batch);
  split<<<grid, kThreads, Lay::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<T*>(a.k_arena),
      static_cast<T*>(a.v_arena), a.table, a.lengths,
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
      a.ws_acc, a.ws_ml, a.n_heads, a.kv_heads, a.groups, a.page_tokens,
      a.pages_per_slot, a.max_len, n_splits, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = a.batch * a.n_heads;
  decode_attn_merge_kernel<T, H><<<(rows + kWarps - 1) / kWarps, kThreads,
                                   0, a.stream>>>(
      a.ws_acc, a.ws_ml, a.lengths, static_cast<T*>(a.out), a.batch,
      a.n_heads, a.max_len, n_splits, Lay::kSplit);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t by_group(int group, const Args& a) {
  switch (group) {
    case 1: return launch<T, H, 1>(a);
    case 2: return launch<T, H, 2>(a);
    case 4: return launch<T, H, 4>(a);
    case 7: return launch<T, H, 7>(a);
    case 8: return launch<T, H, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_head_dim(int head_dim, int group, const Args& a) {
  switch (head_dim) {
    case 16: return by_group<T, 16>(group, a);
    case 64: return by_group<T, 64>(group, a);
    case 128: return by_group<T, 128>(group, a);
    default: return cudaErrorInvalidValue;
  }
}

// Query heads a block computes for a ratio r: r itself where it is one of
// the instantiated counts, else the next one up (the extra heads are zero
// queries); r > 8: 8, over ceil(r / 8) blocks.
int block_heads(int r) {
  if (r <= 2 || r == 4 || r == 7) return r;
  return r == 3 ? 4 : kMaxGroup;
}

}  // namespace

extern "C" {

// Positions a split covers for a type (0 float32, 1 bfloat16) and head
// size (the wrapper sizes the workspace by it); 0 where not instantiated.
int decode_attention_split_positions(int dtype, int head_dim) {
  if ((dtype != 0 && dtype != 1) ||
      (head_dim != 16 && head_dim != 64 && head_dim != 128))
    return 0;
  return split_positions(head_dim * (dtype == 0 ? 4 : 2));
}

// Launch both kernels on `stream`; returns the first CUDA error (0 =
// launched).  dtype: 0 float32, 1 bfloat16 (q, arenas, new rows and out
// alike).  q [B, N, H]; arenas [n_pages, page_tokens, KV, H]; table
// [B, pages_per_slot] and lengths [B] int32; k_new, v_new [B, KV, H];
// ws_acc [B, N, n_splits, H] and ws_ml [B, N, n_splits, 2] fp32, with
// n_splits = ceil(max_len / decode_attention_split_positions(dtype,
// head_dim)); out [B, N, H].  Shapes the kernels do not take are refused with
// cudaErrorInvalidValue.
int decode_attention_launch(const void* q, void* k_arena, void* v_arena,
                            const void* table, const void* lengths,
                            const void* k_new, const void* v_new,
                            void* ws_acc, void* ws_ml, void* out, int dtype,
                            int batch, int n_heads, int kv_heads,
                            int head_dim, int page_tokens,
                            int pages_per_slot, int max_len, float scale,
                            void* stream) {
  if (batch < 1 || batch > 65535 || kv_heads < 1 || n_heads % kv_heads ||
      page_tokens < 1 || pages_per_slot < 1 || max_len < 1 ||
      static_cast<long long>(page_tokens) * pages_per_slot < max_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = n_heads / kv_heads;
  if (r > 2 * kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  const int group = block_heads(r);
  const int groups = (r + group - 1) / group;
  if (kv_heads * groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_arena, v_arena, static_cast<const int*>(table),
               static_cast<const int*>(lengths), k_new, v_new,
               static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), out,
               batch, n_heads, kv_heads, groups, page_tokens, pages_per_slot,
               max_len, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0)
    err = by_head_dim<float>(head_dim, group, a);
  else if (dtype == 1)
    err = by_head_dim<__nv_bfloat16>(head_dim, group, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
