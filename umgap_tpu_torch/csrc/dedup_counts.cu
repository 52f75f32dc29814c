// K4 dedup_counts: per-read sort-unique count of hit taxa.
//
// Replaces umgap_tpu/agg/device.py:79 dedup_counts (the reference's
// agg::count plus the tid != 0 drop of taxa2agg,
// src/commands/taxa2agg.rs:169), which the TPU runs as two lax.sort
// passes, prefix sums and a compaction over the whole (B, N) batch.
// Here one block owns one read group: its N hits (E * 6 * W: 300 at
// 100 bp, 540 at 160 bp) are loaded into shared memory with entries
// <= 0 replaced by INT32_MAX (weight 0), padded to a power of two M and
// bitonic-sorted by taxon id. Each thread then owns M / T consecutive
// sorted slots: it counts run heads (a slot whose id differs from its
// left neighbour and is not padding), a warp-shuffle scan gives each
// head its run index r, and a head with r < k_max sums its run's
// weights left to right and writes (id, count, valid) to column r. The
// output holds the k_max SMALLEST ids in ascending order, INT32_MAX /
// 0 / false padding, and nuniq = the number of distinct ids before
// truncation (for the k_max overflow re-route).
//
// Counts are float32 sums in sorted order: exact for the main path's
// weights of 1.0 (any integer count below 2^24).
//
// Bound on the H100: bytes. Per row it reads N int32 ids (and N float
// weights when given) and writes k_max * 9 + 4 bytes; the sort is
// log2(M)(log2(M)+1)/2 shared-memory compare-exchange stages, well
// under the integer peak at these sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t I32_MAX = 0x7FFFFFFF;

__global__ void dedup_kernel(const int32_t* __restrict__ taxa,
                             const float* __restrict__ weights, int N,
                             int M, int k_max, int32_t* __restrict__ utaxa,
                             float* __restrict__ ucounts,
                             uint8_t* __restrict__ uvalid,
                             int32_t* __restrict__ nuniq) {
  extern __shared__ unsigned char smem[];
  int32_t* key = reinterpret_cast<int32_t*>(smem);
  float* w = reinterpret_cast<float*>(key + M);
  int* warp_sums = reinterpret_cast<int*>(w + M);  // [32]

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int32_t* t = taxa + (long long)row * N;
  const float* wt = weights ? weights + (long long)row * N : nullptr;

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
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31 || tid == T - 1) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < n_warps) warp_sums[lane] = ws;  // inclusive over warps
  }
  __syncthreads();
  int r = incl - cnt + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[n_warps - 1];

  const long long o0 = (long long)row * k_max;
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
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// weights may be null (every hit weighs 1.0).
extern "C" int dedup_counts(const void* taxa, const void* weights, int B,
                            int N, int k_max, void* utaxa, void* ucounts,
                            void* uvalid, void* nuniq, void* stream) {
  if (B <= 0) return 0;
  int M = 32;
  while (M < N) M <<= 1;
  const int threads = M < 256 ? M : 256;
  const size_t smem = (size_t)M * 8 + 32 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dedup_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)taxa, (const float*)weights, N, M, k_max,
      (int32_t*)utaxa, (float*)ucounts, (uint8_t*)uvalid, (int32_t*)nuniq);
  return (int)cudaGetLastError();
}
