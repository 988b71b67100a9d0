// lss_topk: the fused LSS serving pass (paper Algorithm 2), one block per
// query:  hash -> stream the L hit slabs -> logits -> first-occurrence
// dedup -> top-k.
//
// Replaces the TPU kernel src/repro/kernels/lss_topk/kernel.py
// (lss_topk_pallas / _make_kernel with the epilogues _topk_quadratic_row
// and _topk_bitonic_tile).  It computes the same function, not the same
// blocks: the TPU kernel runs a [Bq, d] query tile through [Bq, d]@[d, P]
// MXU products and keeps one row of each; here one block serves one
// query.
//
// Bound on the H100: slab bytes.  A query reads L slabs of P ids and the
// rows of their occupied slots (d elements + an fp32 scale for int8):
// ~230 KB at Delicious-200K in fp32 (L=1, P=808, d=129, ~440 occupied),
// against ~2*d flops a row, far below the fp32 rate.  The first port read
// each row only after its id, a few rows a warp at a time, and sorted all
// ceil_pow2(C) slots: clock64() stamps put 60-70% of a block in that
// dependent chain and 20-30% in the sort.  This design:
//   * streams each slab's occupied span, rows [0, last valid slot], through
//     shared memory with bulk async copies (cp.async.bulk, completion on an
//     mbarrier).  Each warp owns a ring of kWarpStages chunks of ~4 KB and
//     takes every kWarps-th chunk of the block's spans: it copies the next
//     chunk while it dots the current one, and no warp waits on an id or
//     on another warp.  (A block-wide ring of 8 KB chunks, consumed by all
//     warps in step with a barrier per chunk, streamed 2.7x slower with
//     either bulk copies or cp.async: the step, not the copy, set its
//     pace.)
//     A 1D bulk copy needs 16-byte-aligned addresses and sizes, which rows
//     of d=129 are not: each chunk is rounded out to 16 bytes and read at
//     its offset inside the stage (the extra bytes lie in the same
//     16-byte granules, so in mapped memory, and are never used);
//   * dedups only valid ids, in a hash table of slot positions keyed by
//     ids[position]: an insert takes the atomicMin of the position, so a
//     slot is the first occurrence of its id iff its position is the
//     stored minimum.  Load factor <= 0.5 and a mixed hash: at 0.8 with a
//     plain multiplicative hash, the probe chains of full buckets made a
//     few blocks 3x slower than the rest.  The inserts run while the first
//     chunks land;
//   * hashes with the whole block (a warp per hyperplane) from theta as
//     stored, read with coalesced loads;
//   * keeps q, theta, the rings and, where they fit, the per-slot arrays
//     (ids, logits, int8 scales, hash table) in shared memory: ~85 KB at
//     Delicious, so 2 blocks fit on an SM.  Where the per-slot arrays do
//     not fit (C = 16,384 at d = 129) they live in a per-query scratch
//     buffer that the wrapper allocates; the code is the same.
//   * bf16 and int8 rows are widened in registers (int8 times its row's
//     scale, the op of dequantize_int8_rows), so they copy 2x and ~4x
//     fewer bytes.
//
// The wide layout (kWide), for an LM head's width: where q, q/|q|, theta
// and the rings do not fit in the 232,448 B of a block (qwen3-4b's
// d = 2,561 in fp32: 288 KB; arctic-480b's d = 7,169: theta alone is
// 229 KB), the block keeps one fp32 copy of q and the small arrays only.
// Stage 1 reads theta from global memory (the same for every block, so
// it stays in L2) and divides each q element by |q| as it is read, which
// gives the bits of the narrow layout; stage 3 reads each 8-row chunk's
// rows straight from global memory, 16 elements a lane in flight per row,
// with no ring.  Where the narrow layout fits, it is used, unchanged.
//
// Stages (each begins after a __syncthreads()):
//   1. load q_aug and theta, normalise q exactly as kernel.py does
//      (q / max(sqrt(sum q^2), 1e-12)) and hash it (simhash.cuh, a warp
//      per hyperplane); slab t is t*2^K + bucket_t.
//   2. load the C ids (-> cand) and find each slab's span; each warp
//      starts its first chunk; insert the valid ids into the hash table,
//      then mark each slot that is not a first occurrence (id -> -1, logit
//      -> NEG_INF) and count the first occurrences (= sample).
//   3. each warp, chunk by chunk: 8 rows at a time, lanes across d, dot
//      each first-occurrence row with the UNNORMALISED q_aug, as kernel.py
//      does (a transposed shuffle reduction sums the 8 rows at once).
//   4. top-k: k passes of a block-wide max, ties to the lowest original
//      position (the rule of lax.top_k); a picked slot drops to -inf.  A
//      best logit <= NEG_INF/2 gives id -1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "bulk_copy.cuh"
#include "simhash.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAtOnce = 8;            // rows a warp dots together
static_assert(kRowsAtOnce == 8, "warp_sum8 reduces 8 rows");
constexpr int kIdBatch = 8;               // id loads a thread keeps in flight
constexpr int kWarpChunkBytes = 4224;     // slab bytes of one warp's chunk
constexpr int kWarpStages = 2;            // a warp's chunks in its ring
constexpr int kWideLoads = 16;            // wide layout: row loads in flight
constexpr int kSmemLimit = 232448;        // shared memory an H100 block can use
constexpr float kNegInf = -1e30f;         // repro.core.lss.NEG_INF
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15LL;
}

__host__ __device__ inline int ceil_pow2(long long c) {
  int n = 2;
  while (n < c) n <<= 1;
  return n;
}

// Where everything of one block lives.  ops.py mirrors it
// (lss_topk_layout); keep the two equal.
struct Layout {
  int c;                 // candidates L*P
  int rows;              // slab rows per chunk
  int stage;             // bytes of one ring stage
  int hash;              // hash table entries (a power of two)
  long long ring;        // mbarriers, then kWarps x kWarpStages stages
  long long vec;         // q, q/|q|, theta, small arrays
  long long slot;        // ids, logits, (int8) scales, hash table
  bool slot_in_smem;
  long long smem;        // dynamic shared memory
  long long scratch;     // per-query scratch bytes (0: all in smem)
  bool wide;             // theta and rows from global memory, no ring
};

// The narrow layout: q, q/|q|, theta and the rings in shared memory.
__host__ __device__ inline Layout narrow_layout(int d, int k_bits,
                                                int n_tables, int cap,
                                                int itemsize, bool scaled) {
  Layout l;
  l.c = n_tables * cap;
  const int row_bytes = d * itemsize;
  int rows = kWarpChunkBytes / row_bytes;
  rows = rows >= kRowsAtOnce ? rows - rows % kRowsAtOnce
                             : (rows > 1 ? rows : 1);
  l.rows = rows;
  // a copy rounded out to 16 B at both ends adds < 32 bytes
  l.stage = static_cast<int>(align16(static_cast<long long>(rows) *
                                     row_bytes) + 32);
  l.hash = ceil_pow2(2LL * l.c);            // load factor <= 0.5
  const long long kl = static_cast<long long>(k_bits) * n_tables;
  l.ring = static_cast<long long>(kWarps) * kWarpStages * (8 + l.stage);
  // q, qn [d] | theta [d*KL] | reduce [2][2*kWarps] | slab, span [L] |
  // bits [KL] | count
  l.vec = align16(4 * (2LL * d + d * kl + 4 * kWarps + 2LL * n_tables +
                       kl + 1));
  l.slot = align16(4LL * l.c * (scaled ? 3 : 2) + 4LL * l.hash);
  l.slot_in_smem = l.ring + l.vec + l.slot <= kSmemLimit;
  l.smem = l.ring + l.vec + (l.slot_in_smem ? l.slot : 0);
  l.scratch = l.slot_in_smem ? 0 : l.slot;
  l.wide = false;
  return l;
}

// The layout of these shapes: the narrow one where q, q/|q|, theta and
// the rings fit in a block, else the wide one.
__host__ __device__ inline Layout make_layout(int d, int k_bits,
                                              int n_tables, int cap,
                                              int itemsize, bool scaled) {
  Layout l = narrow_layout(d, k_bits, n_tables, cap, itemsize, scaled);
  if (l.ring + l.vec <= kSmemLimit) return l;
  // q [d] | reduce [2][2*kWarps] | slab, span [L] | bits [KL] | count
  const long long kl = static_cast<long long>(k_bits) * n_tables;
  l.wide = true;
  l.rows = kRowsAtOnce;
  l.stage = 0;
  l.ring = 0;
  l.vec = align16(4 * (static_cast<long long>(d) + 4 * kWarps +
                       2LL * n_tables + kl + 1));
  l.slot_in_smem = l.vec + l.slot <= kSmemLimit;
  l.smem = l.vec + (l.slot_in_smem ? l.slot : 0);
  l.scratch = l.slot_in_smem ? 0 : l.slot;
  return l;
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

// ---- the dedup hash table ------------------------------------------------
// An entry holds a slot position (-1: empty); its key is ids[position].
// Every position stored in an entry has the same id, so the entry ends as
// that id's smallest position: its first occurrence.  Linear probing, load
// factor <= 0.5, a mixed hash (ids of one bucket are no random sample).

__device__ __forceinline__ unsigned hash_slot(int id, int shift) {
  unsigned h = static_cast<unsigned>(id);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >> shift;
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// Insert slot p (id = ids[p] >= 0); every id's slots are in ids already.
__device__ __forceinline__ void hash_insert(int* table, const int* ids,
                                            int mask, int shift, int id,
                                            int p) {
  for (unsigned h = hash_slot(id, shift);; h = (h + 1) & mask) {
    int e = load_volatile(&table[h]);
    if (e < 0) {                       // empty: claim it
      e = atomicCAS(&table[h], -1, p);
      if (e < 0) return;
    }
    if (ids[e] == id) {                // this id's entry
      atomicMin(&table[h], p);
      return;
    }
  }
}

// The first occurrence of `id` (which was inserted).
__device__ __forceinline__ int hash_first(const int* table, const int* ids,
                                          int mask, int shift, int id) {
  for (unsigned h = hash_slot(id, shift);; h = (h + 1) & mask) {
    const int e = load_volatile(&table[h]);
    if (ids[e] == id) return e;
  }
}

// The block's chunks walk the tables in order, each table's span in steps
// of `rows`; warp w takes chunks w, w + kWarps, ...  A cursor finds a
// chunk's table by walking forward from the last one it found.
struct Chunk {
  int t = 0, first = 0;  // table, and the index of its first chunk
  int r0 = 0, rows = 0;  // rows [r0, r0 + rows) of table t

  __device__ void seek(int n, const int* span, int rows_per_chunk) {
    for (;;) {
      const int nt = (span[t] + rows_per_chunk - 1) / rows_per_chunk;
      if (n < first + nt) break;
      first += nt;
      ++t;
    }
    r0 = (n - first) * rows_per_chunk;
    rows = min(rows_per_chunk, span[t] - r0);
  }
};

template <typename T, bool kSlotSmem, bool kWide>
__global__ void __launch_bounds__(kThreads) lss_topk_kernel(
    const float* __restrict__ q_aug, const float* __restrict__ theta,
    const int* __restrict__ tids, const T* __restrict__ w,
    const float* __restrict__ scales, float* __restrict__ top_logits,
    int* __restrict__ top_ids, int* __restrict__ sample,
    int* __restrict__ cand, unsigned char* __restrict__ scratch, int d,
    int k_bits, int n_tables, int cap, int top_k) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  // the narrow kernel computes its layout as it did before the wide one
  // existed, so its code does not change
  const Layout lay =
      kWide ? make_layout(d, k_bits, n_tables, cap, sizeof(T), kScaled)
            : narrow_layout(d, k_bits, n_tables, cap, sizeof(T), kScaled);
  const int kl = k_bits * n_tables;
  const int c = lay.c;
  auto* bars = reinterpret_cast<uint64_t*>(smem);  // [kWarps][kWarpStages]
  unsigned char* ring = smem + 8 * kWarps * kWarpStages;
  float* q = reinterpret_cast<float*>(smem + lay.ring);
  float* qn = q + d;                               // narrow only
  float* th = qn + d;                              // [d, KL], as stored
  float* red_v = kWide ? q + d : th + d * kl;
  int* red_p = reinterpret_cast<int*>(red_v + 2 * kWarps);
  int* slab = red_p + 2 * kWarps;
  int* span = slab + n_tables;
  int* bits = span + n_tables;
  int* count = bits + kl;
  unsigned char* slot_base =
      kSlotSmem ? smem + lay.ring + lay.vec
                : scratch + static_cast<size_t>(blockIdx.x) * lay.scratch;
  int* ids = reinterpret_cast<int*>(slot_base);            // [C]
  float* logit = reinterpret_cast<float*>(ids + c);        // [C]
  float* scl = logit + c;                                  // [C], int8
  int* table = reinterpret_cast<int*>(scl + (kScaled ? c : 0));  // [hash]
  const int hmask = lay.hash - 1;
  const int hshift = 32 - (31 - __clz(lay.hash));

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- stage 1: q, theta, normalise + hash ------------------------------
  if (tid == 0) {
    if constexpr (!kWide) {
      for (int i = 0; i < kWarps * kWarpStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    *count = 0;
  }
  for (int t = tid; t < n_tables; t += kThreads) span[t] = 0;
  const float* qg = q_aug + static_cast<size_t>(b) * d;
  float ss = 0.f;
  for (int i = tid; i < d; i += kThreads) {
    const float v = qg[i];
    q[i] = v;
    ss = fmaf(v, v, ss);
  }
  if constexpr (!kWide)
    for (int e = tid; e < d * kl; e += kThreads) th[e] = theta[e];
  for (int h = tid; h < lay.hash; h += kThreads) table[h] = -1;
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
  if constexpr (kWide) {
    for (int j = warp; j < kl; j += kWarps) {
      const float s = simhash_score_div(q, denom, theta + j, kl, d, lane);
      if (lane == 0) bits[j] = s > 0.f ? 1 : 0;
    }
  } else {
    for (int i = tid; i < d; i += kThreads) qn[i] = q[i] / denom;
    __syncthreads();
    for (int j = warp; j < kl; j += kWarps) {
      const float s = simhash_score(qn, th + j, kl, d, lane);
      if (lane == 0) bits[j] = s > 0.f ? 1 : 0;
    }
  }
  __syncthreads();
  for (int t = tid; t < n_tables; t += kThreads) {
    int code = 0;
    for (int j = 0; j < k_bits; ++j) code |= bits[t * k_bits + j] << j;
    slab[t] = (t << k_bits) + code;
  }
  __syncthreads();

  // ---- stage 2: ids -> cand, spans, dedup; the first chunks in flight ---
  for (int p0 = 0; p0 < c; p0 += kThreads * kIdBatch) {
    int id[kIdBatch];
    float sc[kIdBatch];
#pragma unroll
    for (int u = 0; u < kIdBatch; ++u) {         // independent loads first
      const int p = p0 + u * kThreads + tid;
      id[u] = -1;
      sc[u] = 1.f;
      if (p < c) {
        const int t = p / cap;
        const size_t g = static_cast<size_t>(slab[t]) * cap + (p - t * cap);
        id[u] = tids[g];
        if constexpr (kScaled) sc[u] = scales[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kIdBatch; ++u) {
      const int p = p0 + u * kThreads + tid;
      const int t = p < c ? p / cap : -1;
      int end = 0;                                // span end of this slot
      if (p < c) {
        ids[p] = id[u];
        cand[static_cast<size_t>(b) * c + p] = id[u];
        if constexpr (kScaled) scl[p] = sc[u];
        if (id[u] >= 0) end = p - t * cap + 1;
      }
      // one atomicMax per (warp, table): lanes of a table take their max
      const unsigned grp = __match_any_sync(kFull, t);
      end = __reduce_max_sync(grp, end);
      if (t >= 0 && end > 0 && lane == __ffs(grp) - 1)
        atomicMax(&span[t], end);
    }
  }
  __syncthreads();
  int n_chunks = 0;
  for (int t = 0; t < n_tables; ++t)
    n_chunks += (span[t] + lay.rows - 1) / lay.rows;
  // this warp's chunks: n = warp + j * kWarps, j < mine
  const int mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;
  unsigned char* wring = ring + warp * kWarpStages * lay.stage;
  Chunk next;                                  // the next chunk to copy
  uint64_t* wbars = bars + warp * kWarpStages;
  auto fetch = [&](int j) {                    // lane 0 copies chunk j
    if constexpr (kWide) return;
    next.seek(warp + j * kWarps, span, lay.rows);
    const auto src = reinterpret_cast<uintptr_t>(
        w + (static_cast<size_t>(slab[next.t]) * cap + next.r0) * d);
    const uintptr_t lo = src & ~uintptr_t{15};
    const uintptr_t hi =
        (src + static_cast<size_t>(next.rows) * d * sizeof(T) + 15) &
        ~uintptr_t{15};
    if (lane == 0)
      bulk_copy(wring + (j % kWarpStages) * lay.stage,
                reinterpret_cast<const void*>(lo),
                static_cast<unsigned>(hi - lo), &wbars[j % kWarpStages],
                j >= kWarpStages);
  };
  for (int j = 0; j < kWarpStages - 1 && j < mine; ++j) fetch(j);
  for (int p = tid; p < c; p += kThreads) {
    const int id = ids[p];
    if (id >= 0) hash_insert(table, ids, hmask, hshift, id, p);
  }
  __syncthreads();
  int n_first = 0;
  for (int p = tid; p < c; p += kThreads) {
    const int id = ids[p];
    if (id >= 0 && hash_first(table, ids, hmask, hshift, id) == p) {
      ++n_first;
    } else {
      ids[p] = -1;
      logit[p] = kNegInf;
    }
  }
  n_first = warp_sum(n_first);
  if (lane == 0 && n_first) atomicAdd(count, n_first);
  __syncthreads();

  // ---- stage 3: logits of the first occurrences, each warp its chunks ---
  Chunk cur;
  for (int j = 0; j < mine; ++j) {
    if constexpr (kWide) {
      cur.seek(warp + j * kWarps, span, lay.rows);
      const size_t row0 = static_cast<size_t>(slab[cur.t]) * cap + cur.r0;
      const T* rows = w + row0 * d;        // the chunk, in global memory
      const int pos0 = cur.t * cap + cur.r0;
      unsigned live = 0;
      float acc[kRowsAtOnce], sc[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        if (u < cur.rows && ids[pos0 + u] >= 0) live |= 1u << u;
        acc[u] = 0.f;
        sc[u] = 1.f;
        if constexpr (kScaled) {
          if (live >> u & 1) sc[u] = scl[pos0 + u];
        }
      }
      if (!live) continue;
      // kWideLoads elements of each live row in flight a lane before the
      // fmafs use them; each lane still sums i = lane, lane + 32, ... in
      // order
      for (int i0 = lane; i0 < d; i0 += 32 * kWideLoads) {
        T v[kWideLoads][kRowsAtOnce];
        float qv[kWideLoads];
#pragma unroll
        for (int k = 0; k < kWideLoads; ++k) {
          const int i = i0 + 32 * k;
          qv[k] = i < d ? q[i] : 0.f;
#pragma unroll
          for (int u = 0; u < kRowsAtOnce; ++u)
            v[k][u] = (i < d && (live >> u & 1)) ? rows[u * d + i] : T{};
        }
#pragma unroll
        for (int k = 0; k < kWideLoads; ++k) {
          if (i0 + 32 * k >= d) break;
#pragma unroll
          for (int u = 0; u < kRowsAtOnce; ++u)
            if (live >> u & 1)
              acc[u] = fmaf(qv[k], widen(v[k][u], sc[u]), acc[u]);
        }
      }
      const float v = warp_sum8(acc, lane);
      const int u = (lane >> 2) & 7;
      if ((lane & 3) == 0 && (live >> u & 1)) logit[pos0 + u] = v;
      continue;
    }
    if (j + kWarpStages - 1 < mine) fetch(j + kWarpStages - 1);
    mbar_wait(&wbars[j % kWarpStages], (j / kWarpStages) & 1);
    cur.seek(warp + j * kWarps, span, lay.rows);
    const size_t row0 = static_cast<size_t>(slab[cur.t]) * cap + cur.r0;
    const int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(w + row0 * d) & 15);
    const T* buf = reinterpret_cast<const T*>(
        wring + (j % kWarpStages) * lay.stage + off);
    const int pos0 = cur.t * cap + cur.r0;
    for (int j0 = 0; j0 < cur.rows; j0 += kRowsAtOnce) {
      unsigned live = 0;                   // rows to dot (warp-uniform)
      float acc[kRowsAtOnce], sc[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        const int r = j0 + u;
        if (r < cur.rows && ids[pos0 + r] >= 0) live |= 1u << u;
        acc[u] = 0.f;
        sc[u] = 1.f;
        if constexpr (kScaled) {
          if (live >> u & 1) sc[u] = scl[pos0 + r];
        }
      }
      if (!live) continue;
      for (int i = lane; i < d; i += 32) {
        const float qi = q[i];
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u)
          if (live >> u & 1)
            acc[u] = fmaf(qi, widen(buf[(j0 + u) * d + i], sc[u]), acc[u]);
      }
      const float v = warp_sum8(acc, lane);
      const int u = (lane >> 2) & 7;
      if ((lane & 3) == 0 && (live >> u & 1)) logit[pos0 + j0 + u] = v;
    }
    __syncwarp();                          // done with the stage
  }
  __syncthreads();

  // ---- stage 4: k passes of block-wide max ------------------------------
  // Every warp reduces the warps' partials (double-buffered by pass), so
  // a pass needs one barrier; slot i is scanned by thread i % kThreads
  // alone, so the thread that owns the pick drops it for the next pass.
  for (int kk = 0; kk < top_k; ++kk) {
    float bv = -CUDART_INF_F;
    int bp = INT_MAX;
    for (int i = tid; i < c; i += kThreads) argmax_merge(bv, bp, logit[i], i);
    warp_argmax(bv, bp);
    float* pv = red_v + (kk & 1) * kWarps;
    int* pp = red_p + (kk & 1) * kWarps;
    if (lane == 0) {
      pv[warp] = bv;
      pp[warp] = bp;
    }
    __syncthreads();
    bv = lane < kWarps ? pv[lane] : -CUDART_INF_F;
    bp = lane < kWarps ? pp[lane] : INT_MAX;
    warp_argmax(bv, bp);
    bv = __shfl_sync(kFull, bv, 0);
    bp = __shfl_sync(kFull, bp, 0);
    if (tid == 0) {
      const size_t o = static_cast<size_t>(b) * top_k + kk;
      top_logits[o] = bv;
      top_ids[o] = bv > kNegInf / 2 ? ids[bp] : -1;
    }
    if (bp < c && bp % kThreads == tid) logit[bp] = -CUDART_INF_F;
  }
  __syncthreads();
  // ---- end
  if (tid == 0) sample[b] = *count;
}

Layout layout_for(int d, int k_bits, int n_tables, int cap, int storage) {
  const int itemsize = storage == 0 ? 4 : (storage == 1 ? 2 : 1);
  return make_layout(d, k_bits, n_tables, cap, itemsize, storage == 2);
}

template <typename T>
using KernelFn = void (*)(const float*, const float*, const int*, const T*,
                          const float*, float*, int*, int*, int*,
                          unsigned char*, int, int, int, int, int);

// The kernel of this layout: per-slot arrays in shared memory or in the
// scratch, narrow or wide.
template <typename T>
KernelFn<T> kernel_for(const Layout& lay) {
  if (lay.wide)
    return lay.slot_in_smem ? lss_topk_kernel<T, true, true>
                            : lss_topk_kernel<T, false, true>;
  return lay.slot_in_smem ? lss_topk_kernel<T, true, false>
                          : lss_topk_kernel<T, false, false>;
}

template <typename T>
cudaError_t set_smem(const Layout& lay) {
  if (lay.smem > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel_for<T>(lay),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(lay.smem));
}

template <typename T>
int launch(const void* q_aug, const void* theta, const void* tids,
           const void* w, const void* scales, void* top_logits,
           void* top_ids, void* sample, void* cand, void* scratch,
           int n_queries, int d, int k_bits, int n_tables, int cap,
           int top_k, int storage, cudaStream_t stream) {
  const Layout lay = layout_for(d, k_bits, n_tables, cap, storage);
  if (!lay.slot_in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem<T>(lay);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_queries > 0) {
    kernel_for<T>(lay)<<<n_queries, kThreads, lay.smem, stream>>>(
        static_cast<const float*>(q_aug), static_cast<const float*>(theta),
        static_cast<const int*>(tids), static_cast<const T*>(w),
        static_cast<const float*>(scales), static_cast<float*>(top_logits),
        static_cast<int*>(top_ids), static_cast<int*>(sample),
        static_cast<int*>(cand), static_cast<unsigned char*>(scratch), d,
        k_bits, n_tables, cap, top_k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(const Layout& lay) {
  cudaError_t err = set_smem<T>(lay);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel_for<T>(lay), kThreads, lay.smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// storage: 0 = fp32, 1 = bf16, 2 = int8.  ops.py mirrors both sizes.

// Dynamic shared memory of one block (bytes).
long long lss_topk_smem_bytes(int d, int k_bits, int n_tables, int cap,
                              int storage) {
  return layout_for(d, k_bits, n_tables, cap, storage).smem;
}

// Scratch bytes per query (0 when the per-slot arrays fit in the block).
long long lss_topk_scratch_bytes(int d, int k_bits, int n_tables, int cap,
                                 int storage) {
  return layout_for(d, k_bits, n_tables, cap, storage).scratch;
}

// 1 if the layout of these shapes is the wide one, else 0.
int lss_topk_wide(int d, int k_bits, int n_tables, int cap, int storage) {
  return layout_for(d, k_bits, n_tables, cap, storage).wide ? 1 : 0;
}

// Blocks that fit on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the CUDA error.
int lss_topk_blocks_per_sm(int d, int k_bits, int n_tables, int cap,
                           int storage) {
  const Layout lay = layout_for(d, k_bits, n_tables, cap, storage);
  switch (storage) {
    case 0: return blocks_per_sm<float>(lay);
    case 1: return blocks_per_sm<__nv_bfloat16>(lay);
    case 2: return blocks_per_sm<int8_t>(lay);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `scales` is required for int8 and `scratch` (n_queries times
// lss_topk_scratch_bytes) where that is not 0.
int lss_topk_launch(const void* q_aug, const void* theta, const void* tids,
                    const void* w, const void* scales, void* top_logits,
                    void* top_ids, void* sample, void* cand, void* scratch,
                    int n_queries, int d, int k_bits, int n_tables, int cap,
                    int top_k, int storage, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch<float>(q_aug, theta, tids, w, nullptr, top_logits,
                           top_ids, sample, cand, scratch, n_queries, d,
                           k_bits, n_tables, cap, top_k, storage, s);
    case 1:
      return launch<__nv_bfloat16>(q_aug, theta, tids, w, nullptr,
                                   top_logits, top_ids, sample, cand,
                                   scratch, n_queries, d, k_bits, n_tables,
                                   cap, top_k, storage, s);
    case 2:
      return launch<int8_t>(q_aug, theta, tids, w, scales, top_logits,
                            top_ids, sample, cand, scratch, n_queries, d,
                            k_bits, n_tables, cap, top_k, storage, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* lss_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
