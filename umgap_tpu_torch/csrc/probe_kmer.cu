// K2 probe_kmer: packed 9-mer keys -> taxon ids from the quotiented
// bucket table.
//
// Replaces umgap_tpu/ops/lookup.py:198 _probe_dense (kmer branch) and
// the row fetch of the TPU's Pallas probe experiment
// scripts/exp_pallas_dma.py:31 make_kernel, which kept K HBM->VMEM row
// copies in flight per 1024-query tile. On Hopper, many row fetches in
// flight is simply what one thread per query gives: every thread issues
// its row's 16-byte loads at once, and 132 SMs x 2048 threads keep
// hundreds of thousands of rows in flight.
//
// Per query: Feistel-whiten the (20-bit, 25-bit) key with mix_key
// (umgap_tpu/index/table.py:68-86, all uint32 arithmetic), take the home
// bucket = mlo & (nb - 1) and remainder
// rem = (mlo >> nb_bits) | (mhi << (25 - nb_bits)); for r in
// 0..max_probes read the remainder half of the row [rems | vals] with
// 16-byte loads, match rem | (min(r, 1) << 30); a hit reads the one value
// and ends the query, an empty slot (-1) ends it as a miss. Then the
// full-key stash (sorted by (hi, lo) on the host) is binary-searched; a
// stash hit overrides, as in the JAX probe. Invalid lanes return the
// default.
//
// The grouped entry (probe_kmer_grouped) serves a table of `group`
// hash-range shards stacked along the bucket axis: a device's slice of a
// buildindex-dist artifact, shards first .. first + group - 1 of n_total
// (all of them on one device: first = 0, n_total = group). It replaces
// the sub-table choice of umgap_tpu/parallel/sharded.py:314-320
// (owner_of over the n_total shards, less the device's first shard,
// clipped to the group) together with umgap_tpu/ops/lookup.py:231
// (row = sub * nb + bucket): each query computes its sub-table from its
// key, sub = clip((((hash32(hi, lo) >> 16) * n_total) >> 16) - first, 0,
// group - 1), reads row sub * nb + bucket (64-bit indices) and probes
// with wrap-around inside the sub-table. That is one hash32 (about ten
// integer operations) a query and no extra pass or launch. A query the
// routing sent to the wrong device is clipped into a sub-table and
// missed there, as in the JAX probe.
//
// A stash of up to kSmemStashRows rows is copied to each block's shared
// memory and searched there; a larger one is binary-searched in global
// memory through the read-only path, where its upper levels, which every
// query visits, stay in L1 and L2. Every stash size is served. On the
// H100 the copy is the faster to 256 rows (4.9 M queries over the bench
// table: 0.136 against 0.150 ms at 256 rows, 0.129 against 0.139 with
// its own 213), the global search from 1,024 rows on (0.184 against
// 0.205; 2x at 2,048 and 4,096, where the copy is 48 KB a block and
// limits the blocks an SM holds).
//
// Bound on the H100: bytes. Each valid query reads its row's remainder
// half (bk * 4 bytes; a 32-byte sector for bucket8s) plus one value
// sector, so a bucket8s probe moves ~64 B and a bucket64s probe ~288 B;
// every query slot reads 9 B and writes 5 B. Tables beyond the 50 MB L2
// make every probe a DRAM row fetch; the design keeps the loads
// independent and unrolled so that latency is hidden by occupancy rather
// than paid per query.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr uint32_t MASK20 = (1u << 20) - 1;
constexpr uint32_t MASK25 = (1u << 25) - 1;
// stash rows (12 bytes each) copied to shared memory; past this the
// stash is searched in global memory
constexpr int kSmemStashRows = 256;

__device__ __forceinline__ uint32_t mx(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// umgap_tpu/index/table.py hash32: the shard-ownership hash (the same
// constants as csrc/probe_peptide.cu's bucket hash)
__device__ __forceinline__ uint32_t hash32(int32_t hi, int32_t lo) {
  uint32_t h = ((uint32_t)hi * 0x9E3779B1u) ^ ((uint32_t)lo * 0x85EBCA77u);
  h ^= h >> 16;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ long long stash_key(int32_t h, int32_t l) {
  return ((long long)h << 32) | (long long)(uint32_t)l;
}

// GROUPED: rows hold `group` sub-tables of nb buckets each, a query's
// sub-table from its key. SMEM_STASH: the stash is copied to shared
// memory first (else searched in global memory).
template <int BK, bool GROUPED, bool SMEM_STASH>
__global__ void probe_kernel(const int32_t* __restrict__ qhi,
                             const int32_t* __restrict__ qlo,
                             const uint8_t* __restrict__ qvalid, long long n,
                             const int32_t* __restrict__ rows, long long nb,
                             int nb_bits, int max_probes,
                             const int32_t* __restrict__ stash, int S,
                             int default_value, int32_t* __restrict__ out,
                             uint8_t* __restrict__ found, int group,
                             int first, int n_total) {
  extern __shared__ int32_t s_stash[];  // (S, 3): hi, lo, value
  if constexpr (SMEM_STASH) {
    for (int i = threadIdx.x; i < 3 * S; i += blockDim.x)
      s_stash[i] = stash[i];
    __syncthreads();
  }
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int32_t res = default_value;
  uint8_t hit_any = 0;
  if (qvalid[q]) {
    const int32_t khi = qhi[q], klo = qlo[q];
    uint32_t h = (uint32_t)khi, l = (uint32_t)klo;
    l ^= mx(h + 0x9E3779B1u) & MASK25;
    h ^= mx(l + 0x85EBCA77u) & MASK20;
    l ^= mx(h + 0xC2B2AE3Du) & MASK25;
    const uint64_t bmask = (uint64_t)(nb - 1);
    uint64_t bucket = (uint64_t)l & bmask;
    const int32_t rem = (int32_t)((l >> nb_bits) | (h << (25 - nb_bits)));
    uint64_t base = 0;
    if constexpr (GROUPED) {
      // owner_of(hi, lo, n_total): top 16 bits of hash32 range-mapped
      // onto the shards (top < 2^16, n_total <= 2^16: no overflow), then
      // this device's sub-table of it
      const uint32_t top = hash32(khi, klo) >> 16;
      int sub = (int)((top * (uint32_t)n_total) >> 16) - first;
      sub = sub < 0 ? 0 : (sub >= group ? group - 1 : sub);
      base = (uint64_t)sub * (uint64_t)nb;
    }

    for (int r = 0; r <= max_probes; ++r) {
      const int32_t* row;
      if constexpr (GROUPED)
        row = rows + (base + bucket) * (uint64_t)(2 * BK);
      else
        row = rows + bucket * (uint64_t)(2 * BK);
      const int32_t tag = rem | ((r < 1 ? r : 1) << 30);
      const int4* row4 = reinterpret_cast<const int4*>(row);
      int4 v[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) v[i] = __ldg(row4 + i);
      int slot = -1;
      bool empty = false;
#pragma unroll
      for (int i = BK / 4 - 1; i >= 0; --i) {
        if (v[i].w == tag) slot = 4 * i + 3;
        if (v[i].z == tag) slot = 4 * i + 2;
        if (v[i].y == tag) slot = 4 * i + 1;
        if (v[i].x == tag) slot = 4 * i;
        empty |= (v[i].x == -1) | (v[i].y == -1) | (v[i].z == -1) |
                 (v[i].w == -1);
      }
      if (slot >= 0) {
        res = __ldg(row + BK + slot);
        hit_any = 1;
        break;
      }
      if (empty) break;
      bucket = (bucket + 1) & bmask;
    }

    if (S > 0) {
      const long long key = stash_key(khi, klo);
      int a = 0, b = S;  // lower bound
      if constexpr (SMEM_STASH) {
        while (a < b) {
          const int m = (a + b) >> 1;
          if (stash_key(s_stash[3 * m], s_stash[3 * m + 1]) < key)
            a = m + 1;
          else
            b = m;
        }
        if (a < S && s_stash[3 * a] == khi && s_stash[3 * a + 1] == klo) {
          res = s_stash[3 * a + 2];
          hit_any = 1;
        }
      } else {
        while (a < b) {
          const int m = (a + b) >> 1;
          if (stash_key(__ldg(stash + 3 * m), __ldg(stash + 3 * m + 1)) <
              key)
            a = m + 1;
          else
            b = m;
        }
        if (a < S && __ldg(stash + 3 * a) == khi &&
            __ldg(stash + 3 * a + 1) == klo) {
          res = __ldg(stash + 3 * a + 2);
          hit_any = 1;
        }
      }
    }
  }
  out[q] = res;
  found[q] = hit_any;
}

template <int BK, bool GROUPED>
cudaError_t launch(const void* hi, const void* lo, const void* valid,
                   long long n, const void* rows, long long nb, int nb_bits,
                   int max_probes, const void* stash, int S,
                   int default_value, void* out, void* found, int group,
                   int first, int n_total, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (S <= kSmemStashRows)
    probe_kernel<BK, GROUPED, true><<<(unsigned)blocks, threads,
                                      (size_t)S * 3 * sizeof(int32_t),
                                      stream>>>(
        (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid, n,
        (const int32_t*)rows, nb, nb_bits, max_probes, (const int32_t*)stash,
        S, default_value, (int32_t*)out, (uint8_t*)found, group, first,
        n_total);
  else
    probe_kernel<BK, GROUPED, false><<<(unsigned)blocks, threads, 0,
                                       stream>>>(
        (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid, n,
        (const int32_t*)rows, nb, nb_bits, max_probes, (const int32_t*)stash,
        S, default_value, (int32_t*)out, (uint8_t*)found, group, first,
        n_total);
  return cudaGetLastError();
}

template <bool GROUPED>
int dispatch(const void* hi, const void* lo, const void* valid, long long n,
             const void* rows, long long nb, int nb_bits, int bucket,
             int max_probes, const void* stash, int S, int default_value,
             void* out, void* found, int group, int first, int n_total,
             cudaStream_t s) {
  switch (bucket) {
    case 4:
      return (int)launch<4, GROUPED>(hi, lo, valid, n, rows, nb, nb_bits,
                                     max_probes, stash, S, default_value,
                                     out, found, group, first, n_total,
                                     s);
    case 8:
      return (int)launch<8, GROUPED>(hi, lo, valid, n, rows, nb, nb_bits,
                                     max_probes, stash, S, default_value,
                                     out, found, group, first, n_total,
                                     s);
    case 16:
      return (int)launch<16, GROUPED>(hi, lo, valid, n, rows, nb, nb_bits,
                                      max_probes, stash, S, default_value,
                                      out, found, group, first, n_total,
                                     s);
    case 64:
      return (int)launch<64, GROUPED>(hi, lo, valid, n, rows, nb, nb_bits,
                                      max_probes, stash, S, default_value,
                                      out, found, group, first, n_total,
                                     s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One table (nb buckets). Returns cudaErrorInvalidValue for a bucket
// width without an instantiation (the Python wrapper checks first).
extern "C" int probe_kmer(const void* hi, const void* lo, const void* valid,
                          long long n, const void* rows, long long nb,
                          int nb_bits, int bucket, int max_probes,
                          const void* stash, int S, int default_value,
                          void* out, void* found, void* stream) {
  if (n <= 0) return 0;
  return dispatch<false>(hi, lo, valid, n, rows, nb, nb_bits, bucket,
                         max_probes, stash, S, default_value, out, found, 1,
                         0, 1, (cudaStream_t)stream);
}

// `group` sub-tables of nb buckets each, stacked along the bucket axis:
// shards first .. first + group - 1 of the n_total shards of one
// artifact (first = 0, n_total = group: all of them on this device).
extern "C" int probe_kmer_grouped(const void* hi, const void* lo,
                                  const void* valid, long long n,
                                  const void* rows, long long nb,
                                  int nb_bits, int bucket, int max_probes,
                                  const void* stash, int S,
                                  int default_value, void* out, void* found,
                                  int group, int first, int n_total,
                                  void* stream) {
  if (n <= 0) return 0;
  if (group < 1 || n_total > (1 << 16) || first < 0 ||
      first + group > n_total)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(hi, lo, valid, n, rows, nb, nb_bits, bucket,
                        max_probes, stash, S, default_value, out, found,
                        group, first, n_total, (cudaStream_t)stream);
}

// group == 1 takes the ungrouped entry (a device's one shard of a mesh
// needs no sub-table).
extern "C" int probe_kmer_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  if (a.i(14) == 1)
    return probe_kmer(a.ptr(0), a.ptr(1), a.ptr(2), a.i(3), a.ptr(4), a.i(5),
                      (int)a.i(6), (int)a.i(7), (int)a.i(8), a.ptr(9),
                      (int)a.i(10), (int)a.i(11), a.ptr(12), a.ptr(13),
                      a.ptr(17));
  return probe_kmer_grouped(a.ptr(0), a.ptr(1), a.ptr(2), a.i(3), a.ptr(4),
                            a.i(5), (int)a.i(6), (int)a.i(7), (int)a.i(8),
                            a.ptr(9), (int)a.i(10), (int)a.i(11), a.ptr(12),
                            a.ptr(13), (int)a.i(14), (int)a.i(15),
                            (int)a.i(16), a.ptr(17));
}
