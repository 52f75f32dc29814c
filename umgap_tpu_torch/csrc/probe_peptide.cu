// K8 probe_peptide: tryptic fragment fingerprints -> taxon ids from the
// peptide (fingerprint) bucket table.
//
// Replaces the peptide branch of umgap_tpu/ops/lookup.py:265-283
// _probe_dense, which gathers every query's whole row, (Q, 24) int32, into
// HBM once per probe round before comparing.
//
// Per query: bucket = hash32(hi, lo) & (nb - 1)
// (umgap_tpu/index/table.py:119, uint32 arithmetic); for r in
// 0..max_probes read the 96-byte row [key_hi x8 | key_lo x8 | value x8] as
// six 16-byte loads, a slot hits where both key columns equal the query
// (the value of the hit slots is summed, as the JAX probe does; keys are
// unique, so at most one slot hits); a hit ends the query, as does a row
// with an EMPTY (-1) key_hi (a miss). Invalid slots read the default with
// found = false.
//
// Bound on the H100: bytes. Each query slot reads its 8 key bytes and
// valid flag and writes 5 bytes; each row a valid query reads is 96
// bytes. A resident table beyond the 50 MB L2 makes every probe a DRAM
// row fetch, so the kernel is paced by how many row fetches it keeps in
// flight.
//
// Design: a warp works on a window of 32 * Q consecutive query slots.
//   1. each lane loads Q slots' flags and fingerprints (coalesced, all
//      issued together; the next window's are loaded while this window's
//      rows are in flight), and the warp compacts the window's valid
//      queries with __ballot_sync / __popc into a list in shared memory,
//      while every slot's output is staged as (default, false);
//   2. the listed queries are probed 32 * QR a round: a lane issues the
//      six row loads of each of its QR queries before its first compare,
//      so a warp keeps all of the window's rows in flight (about 9 * Q on
//      the tryptic path, where 28% of the slots are valid); a query that
//      neither hits nor meets an empty slot loads its next row in the
//      next probe round (rare: on the bench batch 219,925 rows are read
//      for 219,576 valid queries), so no row is loaded speculatively;
//   3. each listed query writes its value and found flag to its staged
//      slot, and the warp writes the window back in slot order
//      (coalesced).
// The grid is sized to the card (the resident blocks of every SM) and
// strides over the windows. The first version ran one thread a slot:
// with 72% of the slots invalid a warp kept about 9 rows in flight, each
// valid thread waiting on its flag, then its fingerprint, then its row.
// Q = 2 is the default (ops/lookup.py QUERIES_PER_LANE, from
// chip_smoke.py's sweep on the H100; PERF.md, section 6): larger windows
// keep more rows in flight, but the rows held in registers cut the warps
// an SM holds, and past Q = 2 that costs more than it gains.
//
// The grouped entry (probe_peptide_grouped) serves `group` peptide
// sub-tables of nb buckets each stacked along the bucket axis: a
// device's slice, shards first .. first + group - 1 of the n_total
// hash-range shards of one peptide index (ShardedTable.from_shards over
// peptide shards). It replaces the sub-table choice of
// umgap_tpu/parallel/sharded.py:314-320 for kind "peptide" with
// umgap_tpu/ops/lookup.py:265-283 (row = sub * nb + bucket): a listed
// query's sub-table is the owner of its swapped lanes,
// clip((((hash32(lo, hi) >> 16) * n_total) >> 16) - first, 0, group - 1)
// (umgap_tpu/parallel/sharded.py:33-38: the bucket takes hash32(hi, lo)'s
// low bits, so the owner mixes the lanes the other way), its bucket
// hash32(hi, lo)'s low bits inside the sub-table, and the probe wraps
// inside it. The same kernel under a template flag: the sub-table costs
// one more hash32 a listed query, and the ungrouped instances do not
// compute it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int BK = 8;      // slots a bucket row
constexpr int WARPS = 8;   // warps a block
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t hash32(int32_t hi, int32_t lo) {
  uint32_t h = ((uint32_t)hi * 0x9E3779B1u) ^ ((uint32_t)lo * 0x85EBCA77u);
  h ^= h >> 16;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h;
}

// S slots of the window at w0 a lane: flags and fingerprints.
template <int S>
__device__ __forceinline__ void load_window(
    const int32_t* __restrict__ qhi, const int32_t* __restrict__ qlo,
    const uint8_t* __restrict__ qvalid, long long n, long long w0, int lane,
    bool* v, int32_t* hi, int32_t* lo) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const long long q = w0 + k * 32 + lane;
    const bool in = q < n;
    v[k] = in && __ldg(qvalid + q);
    hi[k] = in ? __ldg(qhi + q) : 0;
    lo[k] = in ? __ldg(qlo + q) : 0;
  }
}

// A device's slice of a grouped table: `group` sub-tables, shards
// first .. first + group - 1 of n_total.
struct Slice {
  int group, first, n_total;
};

// Probe the up to 32 * QR listed queries base + t * 32 + lane (t < QR,
// below nv): every row load of a round issued before its compares; a
// query still live after its row loads its next one in the next round.
// GROUPED: each query's rows lie in its sub-table of `sl`.
template <int QR, bool GROUPED>
__device__ __forceinline__ void probe_listed(
    const int32_t* __restrict__ rows, long long mask, int max_probes,
    int default_value, const int32_t* s_hi, const int32_t* s_lo,
    const int16_t* s_slot, int32_t* s_val, uint8_t* s_fnd, int base, int nv,
    int lane, Slice sl) {
  bool live[QR], hit_any[QR];
  int32_t kh_q[QR], kl_q[QR], val[QR];
  long long bucket[QR], first_row[QR];
  int4 row[QR][6];
#pragma unroll
  for (int t = 0; t < QR; ++t) {
    const int idx = base + t * 32 + lane;
    live[t] = idx < nv;
    kh_q[t] = live[t] ? s_hi[idx] : 0;
    kl_q[t] = live[t] ? s_lo[idx] : 0;
    bucket[t] = (long long)(hash32(kh_q[t], kl_q[t]) & (uint32_t)mask);
    first_row[t] = 0;
    if constexpr (GROUPED) {
      // owner_of(..., kind="peptide"): the swapped lanes' hash (top <
      // 2^16, n_total <= 2^16: no overflow), then this slice's sub-table
      const uint32_t top = hash32(kl_q[t], kh_q[t]) >> 16;
      int sub = (int)((top * (uint32_t)sl.n_total) >> 16) - sl.first;
      sub = sub < 0 ? 0 : (sub >= sl.group ? sl.group - 1 : sub);
      first_row[t] = (long long)sub * (mask + 1);
    }
    hit_any[t] = false;
    val[t] = default_value;
  }
  for (int r = 0;; ++r) {
#pragma unroll
    for (int t = 0; t < QR; ++t) {
      if (live[t]) {
        const int4* p =
            (const int4*)(rows + (first_row[t] + bucket[t]) * (3 * BK));
#pragma unroll
        for (int u = 0; u < 6; ++u) row[t][u] = __ldg(p + u);
      }
    }
    bool more = false;
#pragma unroll
    for (int t = 0; t < QR; ++t) {
      if (live[t]) {
        const int32_t kh[BK] = {row[t][0].x, row[t][0].y, row[t][0].z,
                                row[t][0].w, row[t][1].x, row[t][1].y,
                                row[t][1].z, row[t][1].w};
        const int32_t kl[BK] = {row[t][2].x, row[t][2].y, row[t][2].z,
                                row[t][2].w, row[t][3].x, row[t][3].y,
                                row[t][3].z, row[t][3].w};
        const int32_t kv[BK] = {row[t][4].x, row[t][4].y, row[t][4].z,
                                row[t][4].w, row[t][5].x, row[t][5].y,
                                row[t][5].z, row[t][5].w};
        bool hit = false, empty = false;
        int32_t sum = 0;
#pragma unroll
        for (int s = 0; s < BK; ++s) {
          const bool h = kh[s] == kh_q[t] && kl[s] == kl_q[t];
          hit |= h;
          sum += h ? kv[s] : 0;
          empty |= kh[s] == -1;
        }
        if (hit) {
          val[t] = sum;
          hit_any[t] = true;
        }
        live[t] = !hit && !empty;
        bucket[t] = (bucket[t] + 1) & mask;
        more |= live[t];
      }
    }
    if (!more || r >= max_probes) break;
  }
#pragma unroll
  for (int t = 0; t < QR; ++t) {
    const int idx = base + t * 32 + lane;
    if (idx < nv) {
      const int s = s_slot[idx];
      s_val[s] = val[t];
      s_fnd[s] = hit_any[t];
    }
  }
}

// S: slots a lane loads a window (the window is 32 * S slots); QR: rows a
// lane keeps in flight a round (32 * QR listed queries a round);
// GROUPED: rows hold the sub-tables of slice `sl`, nb buckets each.
template <int S, int QR, bool GROUPED>
__global__ void __launch_bounds__(WARPS * 32) probe_peptide_kernel(
    const int32_t* __restrict__ qhi, const int32_t* __restrict__ qlo,
    const uint8_t* __restrict__ qvalid, long long n,
    const int32_t* __restrict__ rows, long long nb, int max_probes,
    int default_value, int32_t* __restrict__ out,
    uint8_t* __restrict__ found, Slice sl) {
  constexpr int WIN = 32 * S;
  __shared__ int32_t s_hi[WARPS][WIN], s_lo[WARPS][WIN], s_val[WARPS][WIN];
  __shared__ int16_t s_slot[WARPS][WIN];
  __shared__ uint8_t s_fnd[WARPS][WIN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1;
  const long long mask = nb - 1;
  const long long stride = (long long)gridDim.x * WARPS * WIN;
  long long w0 = ((long long)blockIdx.x * WARPS + warp) * WIN;
  bool v[S];
  int32_t hi[S], lo[S];
  load_window<S>(qhi, qlo, qvalid, n, w0, lane, v, hi, lo);
  for (; w0 < n; w0 += stride) {
    // ---- 1. compact the window's valid queries -------------------------
    int nv = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const unsigned m = __ballot_sync(FULL, v[k]);
      if (v[k]) {
        const int p = nv + __popc(m & lt);
        s_hi[warp][p] = hi[k];
        s_lo[warp][p] = lo[k];
        s_slot[warp][p] = (int16_t)(k * 32 + lane);
      }
      s_val[warp][k * 32 + lane] = default_value;
      s_fnd[warp][k * 32 + lane] = 0;
      nv += __popc(m);
    }
    __syncwarp();
    // the next window's flags and fingerprints, in flight with the rows
    load_window<S>(qhi, qlo, qvalid, n, w0 + stride, lane, v, hi, lo);

    // ---- 2. the listed queries, 32 * QR a round ------------------------
    for (int base = 0; base < nv; base += 32 * QR)
      probe_listed<QR, GROUPED>(rows, mask, max_probes, default_value,
                                s_hi[warp], s_lo[warp], s_slot[warp],
                                s_val[warp], s_fnd[warp], base, nv, lane,
                                sl);
    __syncwarp();

    // ---- 3. the window back, in slot order ------------------------------
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const long long q = w0 + k * 32 + lane;
      if (q < n) {
        out[q] = s_val[warp][k * 32 + lane];
        found[q] = s_fnd[warp][k * 32 + lane];
      }
    }
    __syncwarp();
  }
}

constexpr int THREADS = WARPS * 32;

// Blocks that fill the card: the kernel's resident blocks an SM times the
// SMs of the current device (cached per device and instance).
template <int S, int QR, bool GROUPED>
cudaError_t card_blocks(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_peptide_kernel<S, QR, GROUPED>, THREADS, 0);
    if (e != cudaSuccess) return e;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <int S, int QR, bool GROUPED>
int launch(const void* hi, const void* lo, const void* valid, long long n,
           const void* rows, long long nb, int max_probes, int default_value,
           void* out, void* found, Slice sl, cudaStream_t stream) {
  int fill = 0;
  const cudaError_t e = card_blocks<S, QR, GROUPED>(&fill);
  if (e != cudaSuccess) return (int)e;
  const long long windows = (n + 32 * S - 1) / (32 * S);
  const long long need = (windows + WARPS - 1) / WARPS;
  const unsigned blocks = (unsigned)(need < fill ? need : fill);
  probe_peptide_kernel<S, QR, GROUPED><<<blocks, THREADS, 0, stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid, n,
      (const int32_t*)rows, nb, max_probes, default_value, (int32_t*)out,
      (uint8_t*)found, sl);
  return (int)cudaGetLastError();
}

template <bool GROUPED>
int dispatch(const void* hi, const void* lo, const void* valid, long long n,
             const void* rows, long long nb, int max_probes,
             int default_value, void* out, void* found, int Q, Slice sl,
             cudaStream_t s) {
#define UMGAP_K8(S, QR)                                                    \
  case S:                                                                  \
    return launch<S, QR, GROUPED>(hi, lo, valid, n, rows, nb, max_probes,  \
                                  default_value, out, found, sl, s);
  switch (Q) {
    UMGAP_K8(1, 1)
    UMGAP_K8(2, 1)
    UMGAP_K8(4, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef UMGAP_K8
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows: (nb, 24) int32, 16-byte aligned; nb a power of two. Q: query
// slots a lane loads a window (1, 2 or 4; a window is 32 * Q slots, about
// 9 * Q of them valid on the tryptic path), each instance with the rows a
// lane keeps in flight a round.
extern "C" int probe_peptide(const void* hi, const void* lo, const void* valid,
                             long long n, const void* rows, long long nb,
                             int max_probes, int default_value, void* out,
                             void* found, int Q, void* stream) {
  if (n <= 0) return 0;
  if (nb < 1 || (nb & (nb - 1)) || ((uintptr_t)rows & 15))
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(hi, lo, valid, n, rows, nb, max_probes,
                         default_value, out, found, Q, Slice{1, 0, 1},
                         (cudaStream_t)stream);
}

// rows: (group * nb, 24) int32, the sub-tables of shards first .. first +
// group - 1 of n_total, nb buckets each (nb a power of two).
extern "C" int probe_peptide_grouped(const void* hi, const void* lo,
                                     const void* valid, long long n,
                                     const void* rows, long long nb,
                                     int max_probes, int default_value,
                                     void* out, void* found, int Q,
                                     int group, int first, int n_total,
                                     void* stream) {
  if (n <= 0) return 0;
  if (nb < 1 || (nb & (nb - 1)) || ((uintptr_t)rows & 15) || group < 1 ||
      n_total > (1 << 16) || first < 0 || first + group > n_total)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(hi, lo, valid, n, rows, nb, max_probes,
                        default_value, out, found, Q,
                        Slice{group, first, n_total}, (cudaStream_t)stream);
}

// group == 1 takes the ungrouped entry (a device's one shard of a mesh
// needs no sub-table).
extern "C" int probe_peptide_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  if (a.i(11) == 1)
    return probe_peptide(a.ptr(0), a.ptr(1), a.ptr(2), a.i(3), a.ptr(4),
                         a.i(5), (int)a.i(6), (int)a.i(7), a.ptr(8),
                         a.ptr(9), (int)a.i(10), a.ptr(14));
  return probe_peptide_grouped(a.ptr(0), a.ptr(1), a.ptr(2), a.i(3),
                               a.ptr(4), a.i(5), (int)a.i(6), (int)a.i(7),
                               a.ptr(8), a.ptr(9), (int)a.i(10),
                               (int)a.i(11), (int)a.i(12), (int)a.i(13),
                               a.ptr(14));
}
