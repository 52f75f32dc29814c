// snap_taxa: the end of taxa2agg for the aggregators that K6 does not
// run (rmq/lca* and rmq/hybrid, agg/device_rmq.py): each group's
// aggregate snapped to its nearest snapped ancestor, and 1 for a group
// with no valid hit:
//   taxon[b] = 1                   when no uvalid[b, :] is set,
//            = snap[agg[b]]        when 0 <= agg[b] < S and it is not NONE,
//            = 0                   otherwise.
//
// Replaces umgap_tpu/agg/device.py:308 snap_batch and the where over
// uvalid.any(-1) after it (umgap_tpu/pipeline/fused.py:122-124): as
// PyTorch around K5 (agg/device.py snap_batch, then the where) that is
// K5's 1-D take and nine launches around it (the clamp, three compares,
// two ands, a select, the any-reduction and a second select). It takes
// no TPU Pallas kernel's place: K5 keeps the take of Pallas #3
// (scripts/exp_pallas_gather.py:47), which the Euler/RMQ tables still
// use. On the tree aggregators K6 does the same at its store
// (csrc/tree_aggregate.cu, Store::put).
//
// Bound on the H100: bytes. The valid mask (B * K bytes) is read once,
// the aggregates (4 B a group) and one snap entry a distinct aggregate,
// and the taxa written once: at the rmq path's 16,384 groups of K = 64
// about 1.2 MB, 0.4 us at 3.35 TB/s, under what one launch costs.
// Design: one launch, one thread a group (256 a block). A thread loads
// its aggregate and its snap entry first (the table, 80 KB for the
// bench's taxonomy, stays in L2) and scans its mask row with 16-byte
// loads, stopping at the first nonzero word: the loads of neighbouring
// threads cover consecutive rows, so a warp reads 32 rows' bytes as one
// contiguous span. A row of K % 16 != 0 bytes or an unaligned mask is
// read a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int32_t NONE = -1;
constexpr int kThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    snap_taxa_kernel(const int32_t* __restrict__ snap, int S,
                     const int32_t* __restrict__ agg,
                     const uint8_t* __restrict__ uvalid, int B, int K,
                     int32_t* __restrict__ out) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int32_t x = agg[b];
  const int32_t s = x >= 0 && x < S ? snap[x] : NONE;
  bool any = false;
  if (VEC) {
    const uint4* row = reinterpret_cast<const uint4*>(uvalid + b * K);
    for (int k = 0; k < (K >> 4) && !any; ++k) {
      const uint4 v = row[k];
      any = (v.x | v.y | v.z | v.w) != 0u;
    }
  } else {
    const uint8_t* row = uvalid + b * K;
    for (int k = 0; k < K && !any; ++k) any = row[k] != 0;
  }
  out[b] = !any ? 1 : s != NONE ? s : 0;
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// snap (S,) int32; agg (B,) int32; uvalid (B, K) bool, contiguous; out
// (B,) int32. K may be 0 (every group then gives 1).
extern "C" int snap_taxa(const void* snap, int S, const void* agg,
                         const void* uvalid, int B, int K, void* out,
                         void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const int32_t* sn = (const int32_t*)snap;
  const int32_t* a = (const int32_t*)agg;
  const uint8_t* v = (const uint8_t*)uvalid;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)(((long long)B + kThreads - 1) / kThreads);
  if (K % 16 == 0 && ((uintptr_t)v & 15) == 0)
    snap_taxa_kernel<true><<<blocks, kThreads, 0, s>>>(sn, S, a, v, B, K, o);
  else
    snap_taxa_kernel<false><<<blocks, kThreads, 0, s>>>(sn, S, a, v, B, K, o);
  return (int)cudaGetLastError();
}

extern "C" int snap_taxa_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return snap_taxa(a.ptr(0), (int)a.i(1), a.ptr(2), a.ptr(3), (int)a.i(4),
                   (int)a.i(5), a.ptr(6), a.ptr(7));
}
