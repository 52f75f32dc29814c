// K6 tree_aggregate: the per-read tree aggregators over a read group's
// deduplicated hit list, one kernel templated on the strategy:
//   hybrid (tree::mix, factor f), lca* (tree::lca) and mrtl (rmq::rtl).
//
// Replaces the plain PyTorch tail of umgap_tpu/agg/device.py:219-305
// (tree_lca_batch, rtl_batch, tree_mix_batch with _argmax_tiebreak,
// :202-212), which the JAX package runs as XLA ops over the whole batch
// and the port's plain version as 25 depth steps of (B, K, K)
// compare-and-sum launches for hybrid.
//
// Inputs per read group b (K hit slots, D depths): lin (B, K, D) int32
// ancestor rows (any group and slot strides, depths adjacent), depth
// (B, K), is_anc (B, K, K) bool ([b, i, j]: slot i is an ancestor-or-
// self of slot j; hybrid does not read it), counts (B, K) float32 (lca*
// does not read them), valid (B, K) bool, utaxa (B, K) int32, all
// contiguous. Output (B,) int32.
//
// Semantics kept exactly (device.py:202-305):
//   hybrid: from the root, descend over D - 1 depths; at depth d the
//     slots below x are the valid ones with lin[d] == x and a depth-(d+1)
//     ancestor (the branch); a branch's sum is the counts of all slots
//     sharing it; with several branches the heaviest (ties: smallest
//     branch id) is taken unless (maxsum / a_base) < factor in float32,
//     a division as written there, and a_base becomes maxsum; a single
//     branch is descended with no factor test; no slot below stops.
//   lca*: if some valid slot j has every valid slot as an ancestor-or-
//     self (a dominated chain), the deepest such j (first on ties);
//     else the ancestor at the deepest depth where all valid lineages
//     agree with the first valid one (depth 0 when none).
//   mrtl: score of j = counts of the valid slots that are ancestors-or-
//     self of j; maximum score, then maximum depth, then minimum id.
// Counts are summed in float32 in slot order; exact for the path's
// integer counts (below 2^24), so the order of the plain version's sums
// does not matter.
//
// Layout. One warp per read group, several groups per block. For
// hybrid, which reads every lineage column it descends through many
// times, the group's lineage tile is staged in the warp's part of shared
// memory transposed to [d][k], so a column lin[:, d] is contiguous and
// lanes reading their own slots hit distinct banks, while the inner
// branch-sum loop over k is a broadcast; a tile above 200 KB (K * D
// large) is read from global memory instead. lca* and mrtl stage only
// the counts and the valid mask (lca* reads lin only in its fallback,
// once, from global memory), so their blocks hold 8 warps at any K.
// Every reduction is a warp shuffle; a block never synchronises. The
// hybrid descent stops at the first stop; only slots below x compute a
// branch sum (K reads each). is_anc is read straight from global memory,
// slot j by lane j % 32 (coalesced), and only where both slots are
// valid, never staged: at the wide program's K = 648 it is 419,904 bytes,
// more than a block's 227 KB.
//
// Bound on the H100: hybrid does about (D - 1) * K^2 compares and adds
// at most, against the bytes of lin plus the counts, valid and output;
// lca* and mrtl read the valid x valid block of is_anc once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int32_t I32_MAX = 0x7FFFFFFF;
constexpr int32_t NONE = -1;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kHybrid = 0, kLca = 1, kMrtl = 2;
constexpr int kLinStageMax = 200 * 1024;

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// per-warp shared memory: c[K] float, sc[K] float, lt[D*K] int32 (when
// staged), v[K] uint8
__host__ __device__ inline size_t warp_bytes(int K, int D, bool stage_lin) {
  return align16((size_t)K * 8 + (stage_lin ? (size_t)K * D * 4 : 0) + K);
}

template <int STRAT>
__global__ void tree_kernel(const int32_t* __restrict__ lin, long long lsb,
                            int lsk, const int32_t* __restrict__ depth,
                            const uint8_t* __restrict__ is_anc,
                            const float* __restrict__ counts,
                            const uint8_t* __restrict__ valid,
                            const int32_t* __restrict__ utaxa, int B, int K,
                            int D, int root, float factor, int stage_lin,
                            int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + w;
  if (b >= B) return;  // whole warps only: b is per warp

  unsigned char* base = smem + (size_t)w * warp_bytes(K, D, stage_lin);
  float* c = reinterpret_cast<float*>(base);
  float* sc = c + K;
  int32_t* lt = reinterpret_cast<int32_t*>(sc + K);
  uint8_t* v = reinterpret_cast<uint8_t*>(lt + (stage_lin ? K * D : 0));

  const int32_t* lg = lin + (long long)b * lsb;
  if (stage_lin) {
    for (int e = lane; e < K * D; e += 32) {
      const int k = e / D, d = e % D;
      lt[d * K + k] = lg[(long long)k * lsk + d];
    }
  }
  for (int k = lane; k < K; k += 32) {
    const bool vv = valid[(long long)b * K + k] != 0;
    v[k] = vv;
    c[k] = vv && counts ? counts[(long long)b * K + k] : 0.0f;
  }
  __syncwarp();
  auto LIN = [&](int d, int k) -> int32_t {
    return stage_lin ? lt[d * K + k] : lg[(long long)k * lsk + d];
  };

  if (STRAT == kHybrid) {
    float part = 0.0f;
    for (int k = lane; k < K; k += 32) part += c[k];
    float a_base = warp_sum_f(part);
    int x = root;
    const float NEG = -INFINITY;
    for (int d = 0; d + 1 < D; ++d) {
      bool any = false;
      float mx = NEG;
      int bmin = I32_MAX, bmax = -1;
      for (int j = lane; j < K; j += 32) {
        const int32_t br = LIN(d + 1, j);
        float bs = NEG;
        if (v[j] && br != NONE && LIN(d, j) == x) {
          bs = 0.0f;
          for (int k = 0; k < K; ++k)
            if (LIN(d + 1, k) == br) bs += c[k];
          any = true;
          bmin = min(bmin, br);
          bmax = max(bmax, br);
          mx = fmaxf(mx, bs);
        }
        sc[j] = bs;
      }
      any = __any_sync(FULL, any);
      if (!any) break;  // nothing below x: stop
      mx = warp_max_f(mx);
      bmin = warp_min_i(bmin);
      bmax = warp_max_i(bmax);
      __syncwarp();
      const bool multi = bmin != bmax;
      if (multi) {
        if ((mx / a_base) < factor) break;  // the heaviest share is too low
        int best = I32_MAX;
        for (int j = lane; j < K; j += 32)
          if (sc[j] != NEG && sc[j] == mx) best = min(best, LIN(d + 1, j));
        x = warp_min_i(best);
        a_base = mx;
      } else {
        x = bmin;
      }
      __syncwarp();
    }
    if (lane == 0) out[b] = x;
    return;
  }

  const uint8_t* ia = is_anc + (long long)b * K * K;
  if (STRAT == kMrtl) {
    float smax = -INFINITY;
    for (int j = lane; j < K; j += 32) {
      float s = -INFINITY;
      if (v[j]) {
        s = 0.0f;
        for (int i = 0; i < K; ++i)
          if (v[i] && ia[(long long)i * K + j]) s += c[i];
      }
      sc[j] = s;
      smax = fmaxf(smax, s);
    }
    smax = warp_max_f(smax);
    __syncwarp();
    int dmax = -1;
    for (int j = lane; j < K; j += 32)
      if (v[j] && sc[j] == smax) dmax = max(dmax, depth[(long long)b * K + j]);
    dmax = warp_max_i(dmax);
    int best = I32_MAX;
    for (int j = lane; j < K; j += 32)
      if (v[j] && sc[j] == smax && depth[(long long)b * K + j] == dmax)
        best = min(best, utaxa[(long long)b * K + j]);
    best = warp_min_i(best);
    if (lane == 0) out[b] = best;
    return;
  }

  // lca*: the deepest dominated slot (first on ties) ...
  int bd = -1, bj = I32_MAX;
  for (int j = lane; j < K; j += 32) {
    if (!v[j]) continue;
    bool dom = true;
    for (int i = 0; i < K && dom; ++i)
      dom = !v[i] || ia[(long long)i * K + j];
    const int dd = depth[(long long)b * K + j];
    if (dom && (dd > bd || (dd == bd && j < bj))) {
      bd = dd;
      bj = j;
    }
  }
  const int dmax = warp_max_i(bd);
  const int jstar = warp_min_i(bd == dmax ? bj : I32_MAX);
  if (dmax >= 0) {
    if (lane == 0) out[b] = utaxa[(long long)b * K + jstar];
    return;
  }
  // ... else the deepest depth where every valid lineage agrees with the
  // first valid one
  int fv = K;
  for (int k = lane; k < K; k += 32)
    if (v[k]) fv = min(fv, k);
  fv = warp_min_i(fv);
  if (fv == K) fv = 0;
  int dstar = 0;
  for (int d = 0; d < D; ++d) {
    const int32_t ref = LIN(d, fv);
    bool ok = true;
    for (int k = lane; k < K; k += 32)
      ok = ok && (!v[k] || LIN(d, k) == ref);
    if (__all_sync(FULL, ok) && ref != NONE) dstar = d;
  }
  if (lane == 0) out[b] = LIN(dstar, fv);
}

template <int STRAT>
int launch(const int32_t* lin, long long lsb, int lsk, const int32_t* depth,
           const uint8_t* is_anc, const float* counts, const uint8_t* valid,
           const int32_t* utaxa, int B, int K, int D, int root, float factor,
           int32_t* out, cudaStream_t stream) {
  const bool stage_lin =
      STRAT == kHybrid && warp_bytes(K, D, true) <= (size_t)kLinStageMax;
  const size_t per_warp = warp_bytes(K, D, stage_lin);
  int wpb = (int)((48 * 1024) / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
  const size_t smem = per_warp * wpb;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_kernel<STRAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + wpb - 1) / wpb;
  tree_kernel<STRAT><<<blocks, 32 * wpb, smem, stream>>>(
      lin, lsb, lsk, depth, is_anc, counts, valid, utaxa, B, K, D, root,
      factor, stage_lin ? 1 : 0, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strategy: 0 hybrid (is_anc unused, may be null), 1 lca* (counts
// unused, may be null), 2 mrtl. lin[b, k, d] is at lin + b * lsb +
// k * lsk + d.
extern "C" int tree_aggregate(int strategy, const void* lin, long long lsb,
                              int lsk, const void* depth, const void* is_anc,
                              const void* counts, const void* valid,
                              const void* utaxa, int B, int K, int D,
                              int root, float factor, void* out,
                              void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  int (*f)(const int32_t*, long long, int, const int32_t*, const uint8_t*,
           const float*, const uint8_t*, const int32_t*, int, int, int, int,
           float, int32_t*, cudaStream_t) = nullptr;
  switch (strategy) {
    case kHybrid: f = launch<kHybrid>; break;
    case kLca: f = launch<kLca>; break;
    case kMrtl: f = launch<kMrtl>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return f((const int32_t*)lin, lsb, lsk, (const int32_t*)depth,
           (const uint8_t*)is_anc, (const float*)counts,
           (const uint8_t*)valid, (const int32_t*)utaxa, B, K, D, root,
           factor, (int32_t*)out, (cudaStream_t)stream);
}

extern "C" int tree_aggregate_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return tree_aggregate((int)a.i(0), a.ptr(1), a.i(2), (int)a.i(3), a.ptr(4),
                        a.ptr(5), a.ptr(6), a.ptr(7), a.ptr(8), (int)a.i(9),
                        (int)a.i(10), (int)a.i(11), (int)a.i(12),
                        (float)a.d(13), a.ptr(14), a.ptr(15));
}
