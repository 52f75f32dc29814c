// K4 dedup_counts: per-read sort-unique count of hit taxa.
//
// Replaces umgap_tpu/agg/device.py:79 dedup_counts (the reference's
// agg::count plus the tid != 0 drop of taxa2agg,
// src/commands/taxa2agg.rs:169), which the TPU runs as two lax.sort
// passes, prefix sums and a compaction over the whole (B, N) batch.
// The output holds the k_max SMALLEST ids in ascending order, INT32_MAX /
// 0 / false padding, and nuniq = the number of distinct ids before
// truncation (for the k_max overflow re-route).
//
// Bound on the H100: bytes. Each row's N ids (and N float weights when
// given) must be read once and k_max * 9 + 4 bytes written; the least
// sorting work is that of each row's n VALID hits (ids > 0), which
// seed-extend leaves few of (on the bench workload a mean of 8 and at
// most 38 of N = 300 or 540), far under the integer peak.
//
// Design, warp path (N <= 1024: 300 hits at 100 bp, 540 at 160 bp; no
// block barrier anywhere). One warp owns one read group, eight groups a
// block. The warp reads its row coalesced (16-byte loads when N is a
// multiple of 4) and compacts the positive ids into a per-warp
// shared-memory buffer with a shuffle prefix sum (__ballot_sync/__popc
// for scalar loads), so the zeros that seed-extend left cost one read
// and nothing else. It then sorts only the n ids it kept: for n <= 32
// (the bench's p99 is 27) one id per lane through a 15-stage shuffle
// bitonic network in registers; for larger n a bitonic network over the
// next power of two >= n in the warp's buffer, all M/2 compare-exchanges
// of a stage spread over the 32 lanes, with __syncwarp between stages.
// Run heads are found by comparing each id with its left neighbour; a
// head's run index is the popcount of the head ballots before it (a
// shuffle scan over the per-32-chunk counts), and its run ends at the
// next head (the next set bit of the chunk's ballot, or the first head
// of a later chunk from a shuffle suffix minimum). An unweighted count
// is that distance, exact. The heads write their (id, count, valid) to
// consecutive columns, the padding columns are written lane by lane,
// and lane 0 writes nuniq.
//
// Weights (taxa2agg -s) are added as the reference's agg::count adds
// them (src/agg/mod.rs:27-36): in float32, one at a time, in input
// order, so that non-dyadic scores (0.1, 0.3) round as there. A
// weighted row sorts (id, input position) pairs, not ids alone: the
// compaction keeps each entry's position in the row where an
// unweighted one keeps nothing, the comparators order equal ids by
// position (positions are distinct, so the order is the stable one
// whatever the network), and a run's head adds the run's weights,
// read from the row in global memory at those positions, left to
// right. The unweighted path (the pipeline's) is unchanged.
//
// A weighted row's kept runs also write their first input position (the
// head's, since equal ids sort by position) to `first`, (B, k_max) int32,
// I32_MAX in the padding: the wrapper orders each row's slots by it, so
// that K6's ordered instances and the rmq aggregators meet a row's taxa
// in first-seen order, the order umgap_tpu's host aggregators add in
// (agg/host.py count keeps it). Only the weighted instances read the
// pointer, the last kernel parameter, so the unweighted ones compile as
// before.
//
// The lower-bound filter (umgap_tpu/pipeline/fused.py:117
// filter_lower_bound, the reference's agg::filter) is applied where a
// run is stored: uvalid = count >= lower_bound, in float32, while the
// id, the count and nuniq (the count before the filter, for the k_max
// overflow) are written as without it. The filter acts on the k_max
// smallest ids kept, as the JAX package's does after its dedup. With no
// bound the wrapper passes -inf, and uvalid is every run kept. It costs
// one compare at each of a row's at most k_max stores, and saves the
// pipeline the filter's two elementwise launches over (B, k_max) and
// its host-side scalar.
//
// Rows past the warp path (N > 1,024 hits: paired reads from about 300
// bp, every rung of the width ladder from 512 bp, and the 12,000 bp
// device width) take the row kernel, one block a row. What bounded the
// block and global paths it replaces: each bitonic-sorted the whole row
// padded to a power of two (32,768 entries at N = 24,576, 120 stages,
// each a barrier and, past 16,384 hits, a pass over L2), though a row
// after seed-extend holds few valid hits and only the count of distinct
// ids and the k_max smallest are wanted; and the global path ran at most
// 264 blocks. The row kernel:
// - compacts the row's positive ids (with their weights) into shared
//   memory in one pass of 16-byte loads, four in flight a thread; a
//   warp reserves room for its valid entries with one shared atomic, so
//   misses cost one read and nothing else;
// - sorts the n valid entries alone: for n <= 32 one warp sorts them in
//   registers and counts them as the warp path does, with no block
//   barrier; larger n take a bitonic network over the whole block in
//   shared memory (the flip form,
//   whose comparators all put the smaller entry first, so the padding to
//   a power of two is virtual: a comparator reaching past n is skipped);
// - numbers the run heads with one block scan of each thread's chunk,
//   finds each run's end as the next head (in the chunk, or the first
//   of a later chunk by a suffix minimum), and counts it as that
//   distance, or for weights as the sum of the run's weights in input
//   order (the sort orders a weighted row's equal ids by position; the
//   head thread adds them one at a time, as the warp path does);
// - writes the k_max smallest runs, the padding and nuniq.
// Room: the row's width in shared memory up to kSmemMax bytes (4 bytes
// an id, 8 with a weight's position: 23,952 hits, the 12,000 bp width,
// take 94 KB, two blocks an SM). A launch whose rows are wider runs one
// block per scratch row the wrapper allocates, in turn over the rows; a
// row with more valid entries than fit sorts them there (the same code
// through generic pointers, barriers ordering the global stores as they
// do the shared ones). ``agg/device.py`` dedup_counts_rows_plain is the same
// formulation in PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int32_t I32_MAX = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 8;

__host__ __device__ int pow2_at_least(int n, int lo) {
  int M = lo;
  while (M < n) M <<= 1;
  return M;
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// The sort's order: ids, and for a weighted row (id, input position)
// pairs; a padding entry is (INT32_MAX, INT32_MAX).
template <bool WEIGHTED>
__device__ __forceinline__ bool before(int32_t a, int32_t pa, int32_t b,
                                       int32_t pb) {
  return WEIGHTED ? (a < b || (a == b && pa < pb)) : a < b;
}

// Compacts the positive ids of one row into key, in input order, and
// for a weighted row their positions in the row into pos; returns their
// number, the same in every lane.
template <bool VEC, bool WEIGHTED>
__device__ int compact_row(const int32_t* __restrict__ t, int N, int lane,
                           int32_t* key, int32_t* pos) {
  int n = 0;
  if (VEC) {
    const int4* t4 = reinterpret_cast<const int4*>(t);
    for (int base = 0; base < N; base += 128) {
      const int c = base + lane * 4;  // N % 4 == 0: all four in range
      const int4 v = c < N ? t4[c >> 2] : make_int4(0, 0, 0, 0);
      const int a[4] = {v.x, v.y, v.z, v.w};
      const int cnt = (a[0] > 0) + (a[1] > 0) + (a[2] > 0) + (a[3] > 0);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int at = n + incl - cnt;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (a[k] > 0) {
          key[at] = a[k];
          if (WEIGHTED) pos[at] = c + k;
          ++at;
        }
      }
      n += __shfl_sync(FULL, incl, 31);
    }
  } else {
    for (int base = 0; base < N; base += 32) {
      const int c = base + lane;
      const int32_t v = c < N ? t[c] : 0;
      const unsigned m = __ballot_sync(FULL, v > 0);
      if (v > 0) {
        const int at = n + __popc(m & lanemask_lt(lane));
        key[at] = v;
        if (WEIGHTED) pos[at] = c;
      }
      n += __popc(m);
    }
  }
  __syncwarp();
  return n;
}

// Sorts key[0, n) ascending (a weighted row's positions alongside, in
// the order of before<>); leaves key[n, 32) INT32_MAX when n <= 32.
template <bool WEIGHTED>
__device__ void warp_sort(int32_t* key, int32_t* pos, int n, int lane) {
  if (n <= 32) {
    int32_t k = lane < n ? key[lane] : I32_MAX;
    int32_t x = (WEIGHTED && lane < n) ? pos[lane] : I32_MAX;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int j = size >> 1; j > 0; j >>= 1) {
        const int32_t ok = __shfl_xor_sync(FULL, k, j);
        const int32_t ox = WEIGHTED ? __shfl_xor_sync(FULL, x, j) : 0;
        const bool keep_min = ((lane & j) == 0) == ((lane & size) == 0);
        if (keep_min ? before<WEIGHTED>(ok, ox, k, x)
                     : before<WEIGHTED>(k, x, ok, ox)) {
          k = ok;
          if (WEIGHTED) x = ox;
        }
      }
    }
    key[lane] = k;
    if (WEIGHTED) pos[lane] = x;
    __syncwarp();
    return;
  }
  int M = 64;
  while (M < n) M <<= 1;
  for (int i = n + lane; i < M; i += 32) {
    key[i] = I32_MAX;
    if (WEIGHTED) pos[i] = I32_MAX;
  }
  __syncwarp();
  const int half = M >> 1;
  for (int size = 2; size <= M; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < half; p += 32) {
        // p with a 0 bit inserted at j's position: the lower partner
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int ixj = i | j;
        const int32_t a = key[i], b = key[ixj];
        const int32_t pa = WEIGHTED ? pos[i] : 0, pb = WEIGHTED ? pos[ixj] : 0;
        if (((i & size) == 0) ? before<WEIGHTED>(b, pb, a, pa)
                              : before<WEIGHTED>(a, pa, b, pb)) {
          key[i] = b;
          key[ixj] = a;
          if (WEIGHTED) {
            pos[i] = pb;
            pos[ixj] = pa;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Writes the runs of the sorted key[0, n) as a row's (id, count, valid)
// columns below k_max from o0 on, with one warp and no block barrier; a
// weighted run's count adds the row's weights wt at the run's positions
// pos, in order. Returns the number of runs (the same in every lane).
template <bool WEIGHTED>
__device__ __forceinline__ int warp_emit_runs(
    const int32_t* key, const int32_t* pos, const float* __restrict__ wt,
    int n, int lane, long long o0,
    int k_max, float lb, int32_t* __restrict__ utaxa,
    float* __restrict__ ucounts, uint8_t* __restrict__ uvalid,
    int32_t* __restrict__ first) {
  // per 32-slot chunk c (at most 32 of them): lane c keeps its number
  // of heads and its first head's position
  const int C = (n + 31) >> 5;
  int myc = 0, myfirst = n;
  for (int c = 0; c < C; ++c) {
    const int t = c * 32 + lane;
    const bool h = t < n && (t == 0 || key[t] != key[t - 1]);
    const unsigned m = __ballot_sync(FULL, h);
    if (lane == c) {
      myc = __popc(m);
      myfirst = m ? c * 32 + __ffs(m) - 1 : n;
    }
  }
  int incl = myc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int base = incl - myc;
  const int U = __shfl_sync(FULL, incl, 31);
  int sfx = myfirst;  // min over chunks >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(FULL, sfx, o);
    if (lane + o < 32) sfx = min(sfx, y);
  }
  int nxt = __shfl_down_sync(FULL, sfx, 1);  // min over chunks > lane
  if (lane == 31) nxt = n;

  for (int c = 0; c < C; ++c) {
    const int t = c * 32 + lane;
    const int32_t v = t < n ? key[t] : I32_MAX;
    const bool h = t < n && (t == 0 || key[t - 1] != v);
    const unsigned m = __ballot_sync(FULL, h);
    const int rb = __shfl_sync(FULL, base, c);
    const int nc = __shfl_sync(FULL, nxt, c);
    if (h) {
      const int r = rb + __popc(m & lanemask_lt(lane));
      if (r < k_max) {
        const unsigned later = lane == 31 ? 0u : m >> (lane + 1);
        const int end = later ? t + __ffs(later) : nc;
        float cnt;
        if (WEIGHTED) {
          cnt = 0.0f;
          for (int u = t; u < end; ++u) cnt += wt[pos[u]];
        } else {
          cnt = (float)(end - t);
        }
        utaxa[o0 + r] = v;
        ucounts[o0 + r] = cnt;
        uvalid[o0 + r] = cnt >= lb;
        if (WEIGHTED) first[o0 + r] = pos[t];
      }
    }
  }
  return U;
}

template <bool VEC, bool WEIGHTED>
__global__ void dedup_warp(const int32_t* __restrict__ taxa,
                           const float* __restrict__ weights, int B, int N,
                           int M, int k_max, float lb,
                           int32_t* __restrict__ utaxa,
                           float* __restrict__ ucounts,
                           uint8_t* __restrict__ uvalid,
                           int32_t* __restrict__ nuniq,
                           int32_t* __restrict__ first) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= B) return;  // the whole warp: no block barrier follows
  int32_t* key = reinterpret_cast<int32_t*>(smem) +
                 (WEIGHTED ? 2 : 1) * M * warp;
  int32_t* pos = key + M;
  const long long r0 = (long long)row * N;
  const int n = compact_row<VEC, WEIGHTED>(taxa + r0, N, lane, key, pos);
  warp_sort<WEIGHTED>(key, pos, n, lane);

  const long long o0 = (long long)row * k_max;
  const int U = warp_emit_runs<WEIGHTED>(
      key, pos, WEIGHTED ? weights + r0 : nullptr, n, lane, o0, k_max, lb,
      utaxa, ucounts, uvalid, first);
  for (int c = U + lane; c < k_max; c += 32) {
    utaxa[o0 + c] = I32_MAX;
    ucounts[o0 + c] = 0.0f;
    uvalid[o0 + c] = 0;
    if (WEIGHTED) first[o0 + c] = I32_MAX;
  }
  if (lane == 0) nuniq[row] = U;
}

// threads a block of the row kernel, by row width: rows of real hits
// hold a few percent of N valid, so narrow rows are few barriers' work
// for most of a block and want small blocks (more rows an SM), wide ones
// want more loads in flight and more threads for a larger sort
// (a sweep of 128, 256 and 512 at the rungs N = 1,944-16,284 and at
// 24,576, PERF.md section 6)
constexpr int kRowThreadsN1 = 4096;   // up to here 128 threads
constexpr int kRowThreadsN2 = 12288;  // up to here 256, above 512
constexpr int kRowLoads = 4;      // 16-byte loads a thread keeps in flight
constexpr int kSmemMax = 200 * 1024;
// valid entries up to which one warp sorts (in registers) and counts a
// row while the block waits; past it the whole block sorts (a sweep of
// 32, 256 and 1,024, PERF.md section 6: one warp's shared-memory sort of
// a few hundred entries loses to the block's)
constexpr int kWarpRowN = 32;

// Appends the positive ids of t[0, N) (and for a weighted row their
// positions in the row) to key/pos at *s_n, reserved a warp at a time,
// so in no fixed order; entries from `cap` on are counted but not
// stored.
template <int T, bool VEC, bool WEIGHTED>
__device__ void compact_block(const int32_t* __restrict__ t, int N,
                              int32_t* key, int32_t* pos, int cap,
                              int* s_n) {
  const int lane = threadIdx.x & 31;
  if (VEC) {
    const int4* t4 = reinterpret_cast<const int4*>(t);
    const int nv = N >> 2;
    for (int base = 0; base < nv; base += T * kRowLoads) {
      int4 a[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int v = base + u * T + threadIdx.x;
        a[u] = v < nv ? t4[v] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int x[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
        const int cnt = (x[0] > 0) + (x[1] > 0) + (x[2] > 0) + (x[3] > 0);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        if (total == 0) continue;  // the whole warp
        int at = 0;
        if (lane == 0) at = atomicAdd(s_n, total);
        at = __shfl_sync(FULL, at, 0) + incl - cnt;
        const int c = (base + u * T + threadIdx.x) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (x[k] > 0) {
            if (at < cap) {
              key[at] = x[k];
              if (WEIGHTED) pos[at] = c + k;
            }
            ++at;
          }
        }
      }
    }
  } else {
    for (int base = 0; base < N; base += T * kRowLoads) {
      int32_t x[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int c = base + u * T + threadIdx.x;
        x[u] = c < N ? t[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const unsigned m = __ballot_sync(FULL, x[u] > 0);
        if (m == 0) continue;
        int at = 0;
        if (lane == 0) at = atomicAdd(s_n, __popc(m));
        at = __shfl_sync(FULL, at, 0) + __popc(m & lanemask_lt(lane));
        if (x[u] > 0 && at < cap) {
          key[at] = x[u];
          if (WEIGHTED) pos[at] = base + u * T + threadIdx.x;
        }
      }
    }
  }
}

template <bool WEIGHTED>
__device__ __forceinline__ void cswap(int32_t* key, int32_t* pos, int i,
                                      int j) {
  const int32_t a = key[i], b = key[j];
  const int32_t pa = WEIGHTED ? pos[i] : 0, pb = WEIGHTED ? pos[j] : 0;
  if (before<WEIGHTED>(b, pb, a, pa)) {
    key[i] = b;
    key[j] = a;
    if (WEIGHTED) {
      pos[i] = pb;
      pos[j] = pa;
    }
  }
}

// Sorts key[0, n) ascending (a weighted row's positions alongside, in
// the order of before<>) with the whole block.
template <int T, bool WEIGHTED>
__device__ void block_sort(int32_t* key, int32_t* pos, int n) {
  const int tid = threadIdx.x;
  if (n <= 32) {
    if (tid < 32) {
      // warp_sort's register network; n <= 32 leaves key[n, 32) alone
      int32_t k = tid < n ? key[tid] : I32_MAX;
      int32_t x = (WEIGHTED && tid < n) ? pos[tid] : I32_MAX;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
          const int32_t ok = __shfl_xor_sync(FULL, k, j);
          const int32_t ox = WEIGHTED ? __shfl_xor_sync(FULL, x, j) : 0;
          const bool keep_min = ((tid & j) == 0) == ((tid & size) == 0);
          if (keep_min ? before<WEIGHTED>(ok, ox, k, x)
                       : before<WEIGHTED>(k, x, ok, ox)) {
            k = ok;
            if (WEIGHTED) x = ox;
          }
        }
      }
      if (tid < n) {
        key[tid] = k;
        if (WEIGHTED) pos[tid] = x;
      }
    }
    __syncthreads();
    return;
  }
  int M = 64;
  while (M < n) M <<= 1;
  const int half = M >> 1;
  for (int k = 2; k <= M; k <<= 1) {
    const int hk = k >> 1;
    // the flip: i with its mirror in the block of k; entries past n are
    // virtual +inf and stay where they are
    for (int p = tid; p < half; p += T) {
      const int off = p & (hk - 1);
      const int i = (p - off) * 2 + off;
      const int j = i + (k - 1 - 2 * off);
      if (j < n) cswap<WEIGHTED>(key, pos, i, j);
    }
    __syncthreads();
    for (int d = hk >> 1; d > 0; d >>= 1) {
      for (int p = tid; p < half; p += T) {
        const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
        if (i + d < n) cswap<WEIGHTED>(key, pos, i, i + d);
      }
      __syncthreads();
    }
  }
}

// One block a row (rows blockIdx.x, + gridDim.x, ...): compact, sort the
// valid entries, count the runs (see the note at the top). `scratch`
// holds one row of N entries a block when rows may overflow `cap`.
template <int T, bool VEC, bool WEIGHTED>
__global__ void __launch_bounds__(T) dedup_rows_kernel(
    const int32_t* __restrict__ taxa, const float* __restrict__ weights,
    int B, int N, int cap, int k_max, float lb, int32_t* __restrict__ utaxa,
    float* __restrict__ ucounts, uint8_t* __restrict__ uvalid,
    int32_t* __restrict__ nuniq, unsigned char* __restrict__ scratch,
    int32_t* __restrict__ fpos) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n, s_u;
  __shared__ int s_cnt[T / 32];
  __shared__ int s_first[T / 32];
  constexpr int kWarps = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* const s_key = reinterpret_cast<int32_t*>(smem);
  int32_t* const s_pos = s_key + cap;

  for (long long row = blockIdx.x; row < B; row += gridDim.x) {
    const int32_t* t = taxa + row * N;
    const float* wt = WEIGHTED ? weights + row * N : nullptr;
    if (tid == 0) s_n = 0;
    __syncthreads();
    compact_block<T, VEC, WEIGHTED>(t, N, s_key, s_pos, cap, &s_n);
    __syncthreads();
    const int n = s_n;
    if (n <= kWarpRowN && pow2_at_least(n, 32) <= cap) {
      // one warp sorts and counts (in the 32 entries warp_sort takes), as
      // the warp path does
      if (warp == 0) {
        warp_sort<WEIGHTED>(s_key, s_pos, n, lane);
        const int U = warp_emit_runs<WEIGHTED>(s_key, s_pos, wt, n, lane,
                                               row * k_max, k_max, lb, utaxa,
                                               ucounts, uvalid, fpos);
        if (lane == 0) {
          s_u = U;
          nuniq[row] = U;
        }
      }
      __syncthreads();
      for (int c = s_u + tid; c < k_max; c += T) {
        utaxa[row * k_max + c] = I32_MAX;
        ucounts[row * k_max + c] = 0.0f;
        uvalid[row * k_max + c] = 0;
        if (WEIGHTED) fpos[row * k_max + c] = I32_MAX;
      }
      __syncthreads();  // the next row reuses the buffers, s_n and s_u
      continue;
    }
    int32_t* key = s_key;
    int32_t* pos = s_pos;
    if (n > cap) {  // the block's scratch row (the launch has one)
      key = reinterpret_cast<int32_t*>(
          scratch + (size_t)blockIdx.x * N * (WEIGHTED ? 8 : 4));
      pos = key + N;
      __syncthreads();
      if (tid == 0) s_n = 0;
      __syncthreads();
      compact_block<T, VEC, WEIGHTED>(t, N, key, pos, N, &s_n);
      __syncthreads();
    }
    block_sort<T, WEIGHTED>(key, pos, n);

    // each thread's chunk of the sorted entries: its heads
    const int C = (n + T - 1) / T;
    const int lo = min(tid * C, n), hi = min(lo + C, n);
    int cnt = 0, first = n;
    for (int i = lo; i < hi; ++i) {
      if (i == 0 || key[i] != key[i - 1]) {
        if (first == n) first = i;
        ++cnt;
      }
    }
    // block scans: exclusive head counts, and the first head after this
    // chunk (a suffix minimum)
    int ic = cnt;
    int sm = first;  // min over lanes >= lane of this warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int yc = __shfl_up_sync(FULL, ic, o);
      const int ys = __shfl_down_sync(FULL, sm, o);
      if (lane >= o) ic += yc;
      if (lane + o < 32) sm = min(sm, ys);
    }
    if (lane == 31) s_cnt[warp] = ic;
    if (lane == 0) s_first[warp] = sm;
    __syncthreads();
    int rank = ic - cnt, U = 0, nxt = __shfl_down_sync(FULL, sm, 1);
    if (lane == 31) nxt = n;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      U += s_cnt[v];
      if (v < warp) rank += s_cnt[v];
      if (v > warp) nxt = min(nxt, s_first[v]);
    }
    const long long o0 = row * k_max;
    int h = -1;  // the pending head
    for (int i = lo; i <= hi; ++i) {
      const bool at_end = i == hi;
      if (!at_end && !(i == 0 || key[i] != key[i - 1])) continue;
      if (h >= 0) {
        if (rank < k_max) {
          const int e = at_end ? nxt : i;
          float cnt = 0.0f;
          if (WEIGHTED) {
            for (int u = h; u < e; ++u) cnt += wt[pos[u]];
          } else {
            cnt = (float)(e - h);
          }
          utaxa[o0 + rank] = key[h];
          ucounts[o0 + rank] = cnt;
          uvalid[o0 + rank] = cnt >= lb;
          if (WEIGHTED) fpos[o0 + rank] = pos[h];
        }
        ++rank;
      }
      h = i;
    }
    for (int c = U + tid; c < k_max; c += T) {
      utaxa[o0 + c] = I32_MAX;
      ucounts[o0 + c] = 0.0f;
      uvalid[o0 + c] = 0;
      if (WEIGHTED) fpos[o0 + c] = I32_MAX;
    }
    if (tid == 0) nuniq[row] = U;
    __syncthreads();  // the next row reuses the buffers and s_n
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int T, bool VEC, bool WEIGHTED>
cudaError_t launch_rows_t(const int32_t* t, const float* w, int B, int N,
                          int k_max, float lb, int cap, int32_t* ut, float* uc,
                          uint8_t* uv, int32_t* nu, unsigned char* scratch,
                          int blocks, int32_t* fs, cudaStream_t s) {
  const size_t smem = (size_t)cap * (WEIGHTED ? 8 : 4);
  const cudaError_t e = allow_smem(dedup_rows_kernel<T, VEC, WEIGHTED>, smem);
  if (e != cudaSuccess) return e;
  dedup_rows_kernel<T, VEC, WEIGHTED><<<blocks, T, smem, s>>>(
      t, w, B, N, cap, k_max, lb, ut, uc, uv, nu, scratch, fs);
  return cudaSuccess;
}

template <bool VEC, bool WEIGHTED>
cudaError_t launch_rows(const int32_t* t, const float* w, int B, int N,
                        int k_max, float lb, int cap, int32_t* ut, float* uc,
                        uint8_t* uv, int32_t* nu, unsigned char* scratch,
                        int blocks, int32_t* fs, cudaStream_t s) {
  if (N <= kRowThreadsN1)
    return launch_rows_t<128, VEC, WEIGHTED>(t, w, B, N, k_max, lb, cap, ut,
                                             uc, uv, nu, scratch, blocks, fs,
                                             s);
  if (N <= kRowThreadsN2)
    return launch_rows_t<256, VEC, WEIGHTED>(t, w, B, N, k_max, lb, cap, ut,
                                             uc, uv, nu, scratch, blocks, fs,
                                             s);
  return launch_rows_t<512, VEC, WEIGHTED>(t, w, B, N, k_max, lb, cap, ut,
                                           uc, uv, nu, scratch, blocks, fs,
                                           s);
}

template <bool VEC, bool WEIGHTED>
cudaError_t launch_warp(const int32_t* taxa, const float* weights, int B,
                        int N, int k_max, float lb, int32_t* utaxa,
                        float* ucounts, uint8_t* uvalid, int32_t* nuniq,
                        int32_t* fs, cudaStream_t s) {
  const int M = pow2_at_least(N, 32);
  const size_t smem =
      (size_t)kWarpsPerBlock * M * (WEIGHTED ? 8 : 4);
  cudaError_t e = allow_smem(dedup_warp<VEC, WEIGHTED>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dedup_warp<VEC, WEIGHTED><<<blocks, kWarpsPerBlock * 32, smem, s>>>(
      taxa, weights, B, N, M, k_max, lb, utaxa, ucounts, uvalid, nuniq,
      fs);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// weights may be null (every hit weighs 1.0). lb: the lower bound, a
// kept run valid when its count >= lb (-inf: every kept run). The warp
// path, for rows of up to 1,024 hits (the wrapper's choice).
extern "C" int dedup_counts(const void* taxa, const void* weights, int B,
                            int N, int k_max, float lb, void* utaxa,
                            void* ucounts, void* uvalid, void* nuniq,
                            void* stream, void* first) {
  if (B <= 0) return 0;
  if (weights != nullptr && first == nullptr)
    return (int)cudaErrorInvalidValue;
  int32_t* fs = (int32_t*)first;
  const int32_t* t = (const int32_t*)taxa;
  const float* w = (const float*)weights;
  int32_t* ut = (int32_t*)utaxa;
  float* uc = (float*)ucounts;
  uint8_t* uv = (uint8_t*)uvalid;
  int32_t* nu = (int32_t*)nuniq;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  // 16-byte row loads need rows of a multiple of 4 entries (and 16-byte
  // aligned bases, which PyTorch's allocations are)
  const bool vec = N % 4 == 0 && ((uintptr_t)t & 15) == 0 &&
                   (w == nullptr || ((uintptr_t)w & 15) == 0);
  if (vec && w)
    e = launch_warp<true, true>(t, w, B, N, k_max, lb, ut, uc, uv, nu, fs,
                                   s);
  else if (vec)
    e = launch_warp<true, false>(t, w, B, N, k_max, lb, ut, uc, uv, nu, fs,
                                   s);
  else if (w)
    e = launch_warp<false, true>(t, w, B, N, k_max, lb, ut, uc, uv, nu, fs,
                                   s);
  else
    e = launch_warp<false, false>(t, w, B, N, k_max, lb, ut, uc, uv, nu, fs,
                                   s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int dedup_counts_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return dedup_counts(a.ptr(0), a.ptr(1), (int)a.i(2), (int)a.i(3),
                      (int)a.i(4), (float)a.d(5), a.ptr(6), a.ptr(7),
                      a.ptr(8), a.ptr(9), a.ptr(10), a.ptr(11));
}

// The row kernel, one block a row, for rows of any N (the wrapper takes
// it past 1,024 hits). cap: valid entries a block keeps in shared memory
// (at most N, cap * (weights ? 8 : 4) <= kSmemMax bytes). With cap < N,
// `scratch` holds `blocks` rows of N entries (4 bytes each, 8 with
// weights) and the launch runs that many blocks; else one a row.
extern "C" int dedup_rows(const void* taxa, const void* weights, int B,
                          int N, int k_max, float lb, int cap, void* utaxa,
                          void* ucounts, void* uvalid, void* nuniq,
                          void* scratch, int blocks, void* stream,
                          void* first) {
  if (B <= 0) return 0;
  const int32_t* t = (const int32_t*)taxa;
  const float* w = (const float*)weights;
  const size_t entry = w ? 8 : 4;
  if (cap < 0 || cap > N || (size_t)cap * entry > (size_t)kSmemMax ||
      (cap < N && (scratch == nullptr || blocks <= 0)) ||
      (w != nullptr && first == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cap == N) blocks = B;
  int32_t* ut = (int32_t*)utaxa;
  float* uc = (float*)ucounts;
  uint8_t* uv = (uint8_t*)uvalid;
  int32_t* nu = (int32_t*)nuniq;
  unsigned char* sc = (unsigned char*)scratch;
  int32_t* fs = (int32_t*)first;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = N % 4 == 0 && ((uintptr_t)t & 15) == 0 &&
                   (w == nullptr || ((uintptr_t)w & 15) == 0);
  cudaError_t e;
  if (vec && w)
    e = launch_rows<true, true>(t, w, B, N, k_max, lb, cap, ut, uc, uv, nu,
                                sc, blocks, fs, s);
  else if (vec)
    e = launch_rows<true, false>(t, w, B, N, k_max, lb, cap, ut, uc, uv, nu,
                                 sc, blocks, fs, s);
  else if (w)
    e = launch_rows<false, true>(t, w, B, N, k_max, lb, cap, ut, uc, uv, nu,
                                 sc, blocks, fs, s);
  else
    e = launch_rows<false, false>(t, w, B, N, k_max, lb, cap, ut, uc, uv, nu,
                                  sc, blocks, fs, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int dedup_rows_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return dedup_rows(a.ptr(0), a.ptr(1), (int)a.i(2), (int)a.i(3),
                    (int)a.i(4), (float)a.d(5), (int)a.i(6), a.ptr(7),
                    a.ptr(8), a.ptr(9), a.ptr(10), a.ptr(11), (int)a.i(12),
                    a.ptr(13), a.ptr(14));
}
