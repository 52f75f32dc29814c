// K8 probe_peptide: tryptic fragment fingerprints -> taxon ids from the
// peptide (fingerprint) bucket table.
//
// Replaces the peptide branch of umgap_tpu/ops/lookup.py:265-283
// _probe_dense, which gathers every query's whole row, (Q, 24) int32, into
// HBM once per probe round before comparing.
//
// Per query (one thread): bucket = hash32(hi, lo) & (nb - 1)
// (umgap_tpu/index/table.py:119, uint32 arithmetic); for r in
// 0..max_probes read the 96-byte row [key_hi x8 | key_lo x8 | value x8] as
// six 16-byte loads, a slot hits where both key columns equal the query
// (the value of the hit slots is summed, as the JAX probe does; keys are
// unique, so at most one slot hits); a hit ends the query, as does a row
// with an EMPTY (-1) key_hi (a miss). Invalid lanes load nothing and
// return the default with found = false.
//
// Bound on the H100: bytes. Each query reads its 8 key bytes and valid
// flag and writes 5 bytes; each row a valid query reads is 96 bytes. A
// resident table beyond the 50 MB L2 makes every probe a DRAM row fetch;
// one thread per query with its row loads issued together keeps many
// fetches in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int BK = 8;  // slots a bucket row

__device__ __forceinline__ uint32_t hash32(int32_t hi, int32_t lo) {
  uint32_t h = ((uint32_t)hi * 0x9E3779B1u) ^ ((uint32_t)lo * 0x85EBCA77u);
  h ^= h >> 16;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h;
}

__global__ void probe_peptide_kernel(const int32_t* __restrict__ qhi,
                                     const int32_t* __restrict__ qlo,
                                     const uint8_t* __restrict__ qvalid,
                                     long long n,
                                     const int32_t* __restrict__ rows,
                                     long long nb, int max_probes,
                                     int default_value,
                                     int32_t* __restrict__ out,
                                     uint8_t* __restrict__ found) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int32_t val = default_value;
  uint8_t hit_any = 0;
  if (qvalid[q]) {
    const int32_t hi = qhi[q], lo = qlo[q];
    long long bucket = (long long)(hash32(hi, lo) & (uint32_t)(nb - 1));
    for (int r = 0; r <= max_probes; ++r) {
      const int4* row = (const int4*)(rows + bucket * (3 * BK));
      const int4 h0 = __ldg(row + 0), h1 = __ldg(row + 1);
      const int4 l0 = __ldg(row + 2), l1 = __ldg(row + 3);
      const int4 v0 = __ldg(row + 4), v1 = __ldg(row + 5);
      const int32_t kh[BK] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const int32_t kl[BK] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const int32_t kv[BK] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      bool hit = false, empty = false;
      int32_t sum = 0;
#pragma unroll
      for (int s = 0; s < BK; ++s) {
        const bool h = kh[s] == hi && kl[s] == lo;
        hit |= h;
        sum += h ? kv[s] : 0;
        empty |= kh[s] == -1;
      }
      if (hit) {
        val = sum;
        hit_any = 1;
        break;
      }
      if (empty) break;
      bucket = (bucket + 1) & (nb - 1);
    }
  }
  out[q] = val;
  found[q] = hit_any;
}

constexpr int THREADS = 256;

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows: (nb, 24) int32, 16-byte aligned; nb a power of two.
extern "C" int probe_peptide(const void* hi, const void* lo, const void* valid,
                             long long n, const void* rows, long long nb,
                             int max_probes, int default_value, void* out,
                             void* found, void* stream) {
  if (n <= 0) return 0;
  if (nb < 1 || (nb & (nb - 1)) || ((uintptr_t)rows & 15))
    return (int)cudaErrorInvalidValue;
  probe_peptide_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid, n,
      (const int32_t*)rows, nb, max_probes, default_value, (int32_t*)out,
      (uint8_t*)found);
  return (int)cudaGetLastError();
}

extern "C" int probe_peptide_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return probe_peptide(a.ptr(0), a.ptr(1), a.ptr(2), a.i(3), a.ptr(4), a.i(5),
                       (int)a.i(6), (int)a.i(7), a.ptr(8), a.ptr(9),
                       a.ptr(10));
}
