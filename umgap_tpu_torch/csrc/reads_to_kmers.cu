// K1 reads_to_kmers: packed DNA reads -> six-frame 9-mer keys.
//
// Replaces, fused into one pass, three stages of the JAX program
// (umgap_tpu/pipeline/fused.py:149-153):
//   umgap_tpu/ops/encoding.py:57  unpack_dna4_device  (4-bit wire -> codes)
//   umgap_tpu/ops/translate.py:88 translate6_batch    (six-frame translation)
//   umgap_tpu/ops/kmers.py:76     pack_windows_batch  (k-window packing)
// The TPU version materialises the codes, the (B, 6, P) peptides and the
// shifted slices in HBM; here one thread owns one (read, frame) lane,
// walks its codons once and rolls the k-window key in a register, so the
// only device-memory traffic is the packed read (L/2 bytes, shared by the
// six frame threads through L1) and the outputs.
//
// Bound on the H100: bytes. Per read the kernel reads L/2 + 4 bytes and
// writes 6 * (W * 9 + 4) bytes (hi, lo int32, valid bool, plen int32);
// the arithmetic (a table lookup and a shift per codon) is far below the
// integer peak. Each thread writes its own row of W values, so the stores
// of a warp are strided by W * 4 bytes; L2 merges them before DRAM.
//
// Semantics held exactly (tests hold the plain version to the JAX
// functions, chip_smoke.py holds this kernel to the plain version):
// - codes above 4 (the odd-length pad nibble included) read as N;
// - the reverse strand uses the read's own length:
//   rc[i] = comp(dna[len - 1 - i]), comp(N) = N;
// - frame f has ncod = max(len - f % 3, 0) / 3 codons; residues at
//   j >= ncod are AA_PAD (31); a peptide shorter than k is padded with 0
//   up to k, so its single window is packed but invalid;
// - window w is valid iff w < ncod - (k - 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int AA_PAD = 31;
constexpr int AA_M = 12;  // 'M'

__device__ __forceinline__ int read_code(const uint8_t* row, int i,
                                         int packed) {
  int c = packed ? ((row[i >> 1] >> ((i & 1) ? 0 : 4)) & 0xF) : row[i];
  return c <= 4 ? c : 4;
}

__global__ void reads_to_kmers_kernel(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L, int k,
    int methionine, const uint8_t* __restrict__ lut,
    int32_t* __restrict__ hi, int32_t* __restrict__ lo,
    uint8_t* __restrict__ valid, int32_t* __restrict__ plens, int W) {
  // lut[0..124]: AA code per codon; lut[128..252]: start-codon flags
  __shared__ uint8_t s_lut[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();

  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_reads * 6) return;
  const int read = (int)(t / 6);
  const int frame = (int)(t % 6);
  const int off = frame % 3;
  const bool rev = frame >= 3;
  int len = lengths[read];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int P = L / 3;
  const int ncod = (len - off > 0 ? len - off : 0) / 3;
  const uint8_t* row = reads + (long long)read * row_bytes;

  plens[t] = ncod;

  const int n_lo = k < 5 ? k : 5;
  const uint64_t key_mask = (k * 5 >= 64) ? ~0ull : ((1ull << (5 * k)) - 1);
  const uint64_t lo_mask = (1ull << (5 * n_lo)) - 1;
  const int n_res = W + k - 1;  // P when P >= k, else k (zero padded)
  const int valid_windows = ncod - (k - 1);
  const long long out0 = t * (long long)W;

  uint64_t key = 0;
  for (int j = 0; j < n_res; ++j) {
    int aa;
    if (j >= P) {
      aa = 0;
    } else if (j >= ncod) {
      aa = AA_PAD;
    } else {
      int c[3];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int p = off + 3 * j + b;
        if (rev) {
          const int d = read_code(row, len - 1 - p, packed);
          c[b] = d < 4 ? 3 - d : 4;
        } else {
          c[b] = read_code(row, p, packed);
        }
      }
      const int codon = c[0] * 25 + c[1] * 5 + c[2];
      aa = s_lut[codon];
      if (methionine && s_lut[128 + codon]) aa = AA_M;
    }
    key = ((key << 5) | (uint64_t)aa) & key_mask;
    if (j >= k - 1) {
      const int w = j - (k - 1);
      hi[out0 + w] = (int32_t)(key >> (5 * n_lo));
      lo[out0 + w] = (int32_t)(key & lo_mask);
      valid[out0 + w] = w < valid_windows ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int reads_to_kmers(const void* reads, int row_bytes, int packed,
                              const void* lengths, int n_reads, int L, int k,
                              int methionine, const void* lut, void* hi,
                              void* lo, void* valid, void* plens, int W,
                              void* stream) {
  if (n_reads <= 0) return 0;
  const int threads = 128;
  const long long lanes = (long long)n_reads * 6;
  const int blocks = (int)((lanes + threads - 1) / threads);
  reads_to_kmers_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
      n_reads, L, k, methionine, (const uint8_t*)lut, (int32_t*)hi,
      (int32_t*)lo, (uint8_t*)valid, (int32_t*)plens, W);
  return (int)cudaGetLastError();
}

extern "C" int reads_to_kmers_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return reads_to_kmers(a.ptr(0), (int)a.i(1), (int)a.i(2), a.ptr(3),
                        (int)a.i(4), (int)a.i(5), (int)a.i(6), (int)a.i(7),
                        a.ptr(8), a.ptr(9), a.ptr(10), a.ptr(11), a.ptr(12),
                        (int)a.i(13), a.ptr(14));
}
