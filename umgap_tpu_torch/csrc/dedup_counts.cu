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
// is that distance, exact; a weighted count is summed left to right in
// sorted order within the run. The heads write their (id, count, valid)
// to consecutive columns, the padding columns are written lane by lane,
// and lane 0 writes nuniq.
//
// Counts are float32: exact for integer weights (the main path's 1.0)
// whose run sums stay below 2^24, as the plain version's prefix-sum
// differences are.
//
// Block path (1024 < N <= 16,384, the long-read and wide routes): one
// 256-thread block per row bitonic-sorts all N entries (entries <= 0 as
// INT32_MAX, weight 0) padded to a power of two in shared memory, a
// block scan numbers the run heads, and each head sums its run.
//
// Global path (N > 16,384: paired reads above 4,124 bp, whose padded
// rows no longer fit a block's shared memory): the block path's steps
// with the row's keys and weights in a global scratch the caller
// allocates, one 1024-thread block per scratch row, each block taking
// rows blockIdx.x, blockIdx.x + gridDim.x, ... A block barrier orders
// the global stores of a stage before the next stage's loads, as it
// does for shared memory. A simple path: every compare-exchange of the
// network goes to L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int32_t I32_MAX = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// Compacts the positive ids of one row (and their weights) into key/w;
// returns their number, the same in every lane.
template <bool VEC, bool WEIGHTED>
__device__ int compact_row(const int32_t* __restrict__ t,
                           const float* __restrict__ wt, int N, int lane,
                           int32_t* key, float* w) {
  int n = 0;
  if (VEC) {
    const int4* t4 = reinterpret_cast<const int4*>(t);
    const float4* w4 = reinterpret_cast<const float4*>(wt);
    for (int base = 0; base < N; base += 128) {
      const int c = base + lane * 4;  // N % 4 == 0: all four in range
      const int4 v = c < N ? t4[c >> 2] : make_int4(0, 0, 0, 0);
      const int a[4] = {v.x, v.y, v.z, v.w};
      float x[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (WEIGHTED && c < N) {
        const float4 f = w4[c >> 2];
        x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
      }
      const int cnt = (a[0] > 0) + (a[1] > 0) + (a[2] > 0) + (a[3] > 0);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int pos = n + incl - cnt;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (a[k] > 0) {
          key[pos] = a[k];
          if (WEIGHTED) w[pos] = x[k];
          ++pos;
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
        const int pos = n + __popc(m & lanemask_lt(lane));
        key[pos] = v;
        if (WEIGHTED) w[pos] = wt[c];
      }
      n += __popc(m);
    }
  }
  __syncwarp();
  return n;
}

// Sorts key[0, n) ascending (weights alongside); leaves key[n, 32)
// INT32_MAX when n <= 32.
template <bool WEIGHTED>
__device__ void warp_sort(int32_t* key, float* w, int n, int lane) {
  if (n <= 32) {
    int32_t k = lane < n ? key[lane] : I32_MAX;
    float x = (WEIGHTED && lane < n) ? w[lane] : 0.0f;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int j = size >> 1; j > 0; j >>= 1) {
        const int32_t ok = __shfl_xor_sync(FULL, k, j);
        const float ox = WEIGHTED ? __shfl_xor_sync(FULL, x, j) : 0.0f;
        const bool keep_min = ((lane & j) == 0) == ((lane & size) == 0);
        if (keep_min ? ok < k : ok > k) {
          k = ok;
          if (WEIGHTED) x = ox;
        }
      }
    }
    key[lane] = k;
    if (WEIGHTED) w[lane] = x;
    __syncwarp();
    return;
  }
  int M = 64;
  while (M < n) M <<= 1;
  for (int i = n + lane; i < M; i += 32) key[i] = I32_MAX;
  __syncwarp();
  const int half = M >> 1;
  for (int size = 2; size <= M; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < half; p += 32) {
        // p with a 0 bit inserted at j's position: the lower partner
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int ixj = i | j;
        const int32_t a = key[i], b = key[ixj];
        if (((i & size) == 0) ? a > b : a < b) {
          key[i] = b;
          key[ixj] = a;
          if (WEIGHTED) {
            const float tw = w[i];
            w[i] = w[ixj];
            w[ixj] = tw;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool VEC, bool WEIGHTED>
__global__ void dedup_warp(const int32_t* __restrict__ taxa,
                           const float* __restrict__ weights, int B, int N,
                           int M, int k_max, int32_t* __restrict__ utaxa,
                           float* __restrict__ ucounts,
                           uint8_t* __restrict__ uvalid,
                           int32_t* __restrict__ nuniq) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= B) return;  // the whole warp: no block barrier follows
  int32_t* key = reinterpret_cast<int32_t*>(smem) +
                 (WEIGHTED ? 2 : 1) * M * warp;
  float* w = reinterpret_cast<float*>(key + M);
  const long long r0 = (long long)row * N;
  const int n = compact_row<VEC, WEIGHTED>(
      taxa + r0, WEIGHTED ? weights + r0 : nullptr, N, lane, key, w);
  warp_sort<WEIGHTED>(key, w, n, lane);

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

  const long long o0 = (long long)row * k_max;
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
          for (int u = t; u < end; ++u) cnt += w[u];
        } else {
          cnt = (float)(end - t);
        }
        utaxa[o0 + r] = v;
        ucounts[o0 + r] = cnt;
        uvalid[o0 + r] = 1;
      }
    }
  }
  for (int c = U + lane; c < k_max; c += 32) {
    utaxa[o0 + c] = I32_MAX;
    ucounts[o0 + c] = 0.0f;
    uvalid[o0 + c] = 0;
  }
  if (lane == 0) nuniq[row] = U;
}

// One row through the block path's steps: key and w hold M entries (in
// shared memory, or the row's global scratch), warp_sums 32 ints of
// shared memory.
__device__ void block_dedup_row(const int32_t* __restrict__ t,
                                const float* __restrict__ wt, int N, int M,
                                int k_max, int32_t* key, float* w,
                                int* warp_sums, int32_t* __restrict__ utaxa,
                                float* __restrict__ ucounts,
                                uint8_t* __restrict__ uvalid, int32_t* nuniq,
                                long long row) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  for (int i = tid; i < M; i += T) {
    int32_t v = i < N ? t[i] : 0;
    key[i] = v > 0 ? v : I32_MAX;
    w[i] = v > 0 ? (wt ? wt[i] : 1.0f) : 0.0f;
  }
  __syncthreads();

  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < M; i += T) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int32_t a = key[i], b = key[ixj];
          const bool up = (i & k) == 0;
          if (up ? (a > b) : (a < b)) {
            key[i] = b;
            key[ixj] = a;
            const float tw = w[i];
            w[i] = w[ixj];
            w[ixj] = tw;
          }
        }
      }
      __syncthreads();
    }
  }

  const int C = M / T;  // M >= T, both powers of two
  const int lo = tid * C;
  int cnt = 0;
  for (int i = lo; i < lo + C; ++i)
    cnt += key[i] != I32_MAX && (i == 0 || key[i - 1] != key[i]);

  // exclusive block scan of cnt
  const int lane = tid & 31, warp = tid >> 5, n_warps = (T + 31) >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31 || tid == T - 1) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < n_warps) warp_sums[lane] = ws;  // inclusive over warps
  }
  __syncthreads();
  int r = incl - cnt + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[n_warps - 1];

  const long long o0 = row * k_max;
  for (int i = lo; i < lo + C; ++i) {
    const int32_t v = key[i];
    if (v == I32_MAX || (i > 0 && key[i - 1] == v)) continue;
    if (r < k_max) {
      float s = 0.0f;
      for (int j = i; j < M && key[j] == v; ++j) s += w[j];
      utaxa[o0 + r] = v;
      ucounts[o0 + r] = s;
      uvalid[o0 + r] = 1;
    }
    ++r;
  }
  for (int c = total + tid; c < k_max; c += T) {
    utaxa[o0 + c] = I32_MAX;
    ucounts[o0 + c] = 0.0f;
    uvalid[o0 + c] = 0;
  }
  if (tid == 0) nuniq[row] = total;
  __syncthreads();  // key, w and warp_sums are reused by the next row
}

__global__ void dedup_block(const int32_t* __restrict__ taxa,
                            const float* __restrict__ weights, int N,
                            int M, int k_max, int32_t* __restrict__ utaxa,
                            float* __restrict__ ucounts,
                            uint8_t* __restrict__ uvalid,
                            int32_t* __restrict__ nuniq) {
  extern __shared__ unsigned char smem[];
  int32_t* key = reinterpret_cast<int32_t*>(smem);
  float* w = reinterpret_cast<float*>(key + M);
  int* warp_sums = reinterpret_cast<int*>(w + M);  // [32]
  const long long row = blockIdx.x;
  block_dedup_row(taxa + row * N, weights ? weights + row * N : nullptr, N,
                  M, k_max, key, w, warp_sums, utaxa, ucounts, uvalid, nuniq,
                  row);
}

// The global path: block b sorts rows b, b + gridDim.x, ... in its
// scratch row of M keys and M weights.
__global__ void dedup_global(const int32_t* __restrict__ taxa,
                             const float* __restrict__ weights, int B, int N,
                             int M, int k_max, int32_t* __restrict__ utaxa,
                             float* __restrict__ ucounts,
                             uint8_t* __restrict__ uvalid,
                             int32_t* __restrict__ nuniq,
                             unsigned char* __restrict__ scratch) {
  __shared__ int warp_sums[32];
  int32_t* key =
      reinterpret_cast<int32_t*>(scratch + (size_t)blockIdx.x * M * 8);
  float* w = reinterpret_cast<float*>(key + M);
  for (long long row = blockIdx.x; row < B; row += gridDim.x)
    block_dedup_row(taxa + row * N, weights ? weights + row * N : nullptr,
                    N, M, k_max, key, w, warp_sums, utaxa, ucounts, uvalid,
                    nuniq, row);
}

int pow2_at_least(int n, int lo) {
  int M = lo;
  while (M < n) M <<= 1;
  return M;
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool VEC, bool WEIGHTED>
cudaError_t launch_warp(const int32_t* taxa, const float* weights, int B,
                        int N, int k_max, int32_t* utaxa, float* ucounts,
                        uint8_t* uvalid, int32_t* nuniq, cudaStream_t s) {
  const int M = pow2_at_least(N, 32);
  const size_t smem =
      (size_t)kWarpsPerBlock * M * (WEIGHTED ? 8 : 4);
  cudaError_t e = allow_smem(dedup_warp<VEC, WEIGHTED>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dedup_warp<VEC, WEIGHTED><<<blocks, kWarpsPerBlock * 32, smem, s>>>(
      taxa, weights, B, N, M, k_max, utaxa, ucounts, uvalid, nuniq);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// weights may be null (every hit weighs 1.0). path: 1 the warp path (the
// wrapper chooses it for N <= 1024), 0 the block path (N <= 16,384), 2
// the global path, with `scratch` of scratch_rows * M * 8 bytes (M the
// power of two >= N) and scratch_rows blocks.
extern "C" int dedup_counts(const void* taxa, const void* weights, int B,
                            int N, int k_max, void* utaxa, void* ucounts,
                            void* uvalid, void* nuniq, int path,
                            void* scratch, int scratch_rows, void* stream) {
  if (B <= 0) return 0;
  const int32_t* t = (const int32_t*)taxa;
  const float* w = (const float*)weights;
  int32_t* ut = (int32_t*)utaxa;
  float* uc = (float*)ucounts;
  uint8_t* uv = (uint8_t*)uvalid;
  int32_t* nu = (int32_t*)nuniq;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (path == 2) {
    if (scratch == nullptr || scratch_rows <= 0)
      return (int)cudaErrorInvalidValue;
    const int M = pow2_at_least(N, 1024);
    const int blocks = scratch_rows < B ? scratch_rows : B;
    dedup_global<<<blocks, 1024, 0, s>>>(t, w, B, N, M, k_max, ut, uc, uv,
                                         nu, (unsigned char*)scratch);
  } else if (path == 1) {
    // 16-byte row loads need rows of a multiple of 4 entries (and
    // 16-byte aligned bases, which PyTorch's allocations are)
    const bool vec = N % 4 == 0 && ((uintptr_t)t & 15) == 0 &&
                     (w == nullptr || ((uintptr_t)w & 15) == 0);
    if (vec && w)
      e = launch_warp<true, true>(t, w, B, N, k_max, ut, uc, uv, nu, s);
    else if (vec)
      e = launch_warp<true, false>(t, w, B, N, k_max, ut, uc, uv, nu, s);
    else if (w)
      e = launch_warp<false, true>(t, w, B, N, k_max, ut, uc, uv, nu, s);
    else
      e = launch_warp<false, false>(t, w, B, N, k_max, ut, uc, uv, nu, s);
  } else {
    const int M = pow2_at_least(N, 32);
    const int threads = M < 256 ? M : 256;
    const size_t smem = (size_t)M * 8 + 32 * sizeof(int);
    e = allow_smem(dedup_block, smem);
    if (e == cudaSuccess)
      dedup_block<<<B, threads, smem, s>>>(t, w, N, M, k_max, ut, uc, uv,
                                           nu);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int dedup_counts_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return dedup_counts(a.ptr(0), a.ptr(1), (int)a.i(2), (int)a.i(3), (int)a.i(4),
                      a.ptr(5), a.ptr(6), a.ptr(7), a.ptr(8), (int)a.i(9),
                      a.ptr(10), (int)a.i(11), a.ptr(12));
}
