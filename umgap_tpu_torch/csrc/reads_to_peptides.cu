// K7 reads_to_peptides: packed DNA reads -> six-frame tryptic fragment
// fingerprints.
//
// Replaces, fused into one pass, the chain of the JAX tryptic program
// (umgap_tpu/pipeline/tryptic.py:186-190):
//   umgap_tpu/ops/encoding.py:57   unpack_dna4_device     (4-bit wire -> codes)
//   umgap_tpu/ops/translate.py:88  translate6_batch       (six-frame translation)
//   umgap_tpu/pipeline/tryptic.py:89 tryptic_digest_device (digest, FNV, compaction)
// The TPU version materialises the codes, the (R, 6, P) peptides, a
// (R, P) state per unrolled scan step and a sort over P slots per lane in
// HBM; here nothing but the packed reads and the outputs touches device
// memory.
//
// Bound on the H100: bytes. Per read the kernel reads L/2 + 4 bytes and
// writes 6 * F * 9 bytes (h1, h2 int32, valid bool), F = (L / 3) / 9 + 1;
// the work per residue (a table lookup, two FNV steps) is far below the
// integer peak.
//
// Design (simple first): a block owns R consecutive reads.
//   1. load: the block's R * row_bytes span of the packed reads with
//      16-byte loads (byte loads for an unaligned head and tail), then the
//      codes, unpacked once a base (as K1, csrc/reads_to_kmers.cu);
//   2. translate: one thread per (read, frame, residue) writes the residue
//      code into aa[R * 6][P];
//   3. digest: one thread per (read, frame) lane walks its residues once,
//      keeps the two FNV-1a lanes and the fragment length in registers and
//      writes each emitted fragment to the next of its F slots; the slots
//      after the last emitted one get 0.
// Long reads halve R to keep a block within 48 KB, then opt in to more;
// reads too long for the tile even at R = 1 (about 3.5 bytes of shared
// memory a base: above ~66 kb) take the direct kernel, one thread a lane,
// which translates each codon straight from the packed read in global
// memory.
//
// Semantics held exactly (tests hold the plain version to the JAX
// function, chip_smoke.py holds this kernel to the plain version):
// - codes above 4 (the odd-length pad nibble included) read as N; the
//   reverse strand uses the read's own length; frame f has
//   ncod = max(len - f % 3, 0) / 3 residues (as K1);
// - a residue is a member iff j < ncod and it is not '*' (26); a fragment
//   boundary falls after every K (10) or R (17) whose successor is a
//   member and not P (15), and at every '*', which is dropped;
// - h1 = (h1 ^ c) * 0x01000193 from 0x811C9DC5,
//   h2 = (h2 ^ (c + 0x9E37)) * 0x01000193 from 0xCBF29CE4, in uint32;
//   an h1 of 0xFFFFFFFF is written as 0 (EMPTY stays unambiguous);
// - fragments of min_len..max_len residues are emitted, left-compacted in
//   their order, at most F a lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int AA_STOP = 26;
constexpr int AA_PAD = 31;
constexpr int AA_K = 10, AA_R = 17, AA_P = 15;
constexpr uint32_t FNV_OFFSET = 0x811C9DC5u;
constexpr uint32_t FNV_OFFSET2 = 0xCBF29CE4u;
constexpr uint32_t FNV_PRIME = 0x01000193u;
constexpr int THREADS = 256;

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// Shared memory of one block: [packed span + 16 | ncod R*6 | base R*6 |
// lut 128 | codes R*LP | aa R*6*P], LP codes a read.
__host__ __device__ __forceinline__ int smem_bytes(int R, int row_bytes,
                                                   int packed, int P) {
  const int lp = packed ? 2 * row_bytes : row_bytes;
  return align16(R * row_bytes + 16) + 2 * 4 * 6 * R + 128 +
         align16(R * lp) + R * 6 * P;
}

// Walk one (read, frame) lane of ncod residues, aa(j) giving residue j,
// and write its F fingerprint slots.
template <typename Residue>
__device__ __forceinline__ void digest_lane(Residue aa, int ncod, int F,
                                            int min_len, int max_len,
                                            int32_t* h1o, int32_t* h2o,
                                            uint8_t* vo) {
  int slot = 0;
  uint32_t h1 = FNV_OFFSET, h2 = FNV_OFFSET2;
  int ln = 0;
  bool prev_member = false, prev_cleave = false;
  int a = ncod > 0 ? aa(0) : AA_PAD;
  for (int j = 0; j < ncod; ++j) {
    const int nxt = j + 1 < ncod ? aa(j + 1) : AA_PAD;
    const bool m = a != AA_STOP;
    const bool nm = j + 1 < ncod && nxt != AA_STOP;
    const bool cleave = m && (a == AA_K || a == AA_R) && nm && nxt != AA_P;
    if (m) {
      if (!prev_member || prev_cleave) {
        h1 = FNV_OFFSET;
        h2 = FNV_OFFSET2;
        ln = 0;
      }
      h1 = (h1 ^ (uint32_t)a) * FNV_PRIME;
      h2 = (h2 ^ ((uint32_t)a + 0x9E37u)) * FNV_PRIME;
      ++ln;
      if ((!nm || cleave) && ln >= min_len && ln <= max_len && slot < F) {
        h1o[slot] = h1 == 0xFFFFFFFFu ? 0 : (int32_t)h1;
        h2o[slot] = (int32_t)h2;
        vo[slot] = 1;
        ++slot;
      }
    }
    prev_member = m;
    prev_cleave = cleave;
    a = nxt;
  }
  for (; slot < F; ++slot) {
    h1o[slot] = 0;
    h2o[slot] = 0;
    vo[slot] = 0;
  }
}

__device__ __forceinline__ int clamp_len(int len, int L) {
  return len < 0 ? 0 : (len > L ? L : len);
}

__global__ void __launch_bounds__(THREADS) reads_to_peptides_kernel(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L,
    const uint8_t* __restrict__ lut, int32_t* __restrict__ h1,
    int32_t* __restrict__ h2, uint8_t* __restrict__ valid, int F,
    int min_len, int max_len, int R) {
  const int P = L / 3;
  const int LP = packed ? 2 * row_bytes : row_bytes;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_dna = smem;
  int32_t* s_ncod = (int32_t*)(smem + align16(R * row_bytes + 16));
  int32_t* s_base = s_ncod + 6 * R;
  uint8_t* s_lut = (uint8_t*)(s_base + 6 * R);
  uint8_t* s_code = s_lut + 128;
  uint8_t* s_aa = s_code + align16(R * LP);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, n_reads - r0);

  // ---- 1. load --------------------------------------------------------
  for (int i = tid; i < 125; i += THREADS) s_lut[i] = lut[i];
  // per lane: its residues, and where its first codon starts in the
  // read's codes (~start on the reverse strand)
  for (int i = tid; i < nr * 6; i += THREADS) {
    const int r = i / 6, f = i - r * 6;
    const int off = f < 3 ? f : f - 3;
    const int len = clamp_len(lengths[r0 + r], L);
    s_ncod[i] = (len - off > 0 ? len - off : 0) / 3;
    s_base[i] = f < 3 ? r * LP + off : ~(r * LP + len - 1 - off);
  }
  const uint8_t* g0 = reads + (long long)r0 * row_bytes;
  const int span = nr * row_bytes;
  const int head = (int)((uintptr_t)g0 & 15);
  const int lead = min((16 - head) & 15, span);
  const int nvec = (span - lead) >> 4;
  const int tail0 = lead + (nvec << 4);
  uint8_t* sd = s_dna + head;
  if (tid < lead) sd[tid] = g0[tid];
  {
    const uint4* gv = (const uint4*)(g0 + lead);
    uint4* sv = (uint4*)(sd + lead);
    for (int v = tid; v < nvec; v += THREADS) sv[v] = __ldg(gv + v);
  }
  for (int i = tail0 + tid; i < span; i += THREADS) sd[i] = g0[i];
  __syncthreads();
  if (packed) {
    for (int b = tid; b < span; b += THREADS) {
      const int x = sd[b];
      s_code[2 * b] = (uint8_t)min(x >> 4, 4);
      s_code[2 * b + 1] = (uint8_t)min(x & 0xF, 4);
    }
  } else {
    for (int b = tid; b < span; b += THREADS) s_code[b] = min((int)sd[b], 4);
  }
  __syncthreads();

  // ---- 2. translate: item it = (lane, j) -------------------------------
  const int n_items = nr * 6 * P;
  for (int it = tid; it < n_items; it += THREADS) {
    const int lane = it / P;
    const int j = it - lane * P;
    int aa = AA_PAD;
    if (j < s_ncod[lane]) {
      const int base = s_base[lane];
      int codon;
      if (base >= 0) {
        const uint8_t* c = s_code + base + 3 * j;
        codon = c[0] * 25 + c[1] * 5 + c[2];
      } else {
        const uint8_t* c = s_code + ~base - 3 * j;
        const int c0 = c[0], c1 = c[-1], c2 = c[-2];
        codon = (c0 < 4 ? 3 - c0 : 4) * 25 + (c1 < 4 ? 3 - c1 : 4) * 5 +
                (c2 < 4 ? 3 - c2 : 4);
      }
      aa = s_lut[codon];
    }
    s_aa[it] = (uint8_t)aa;
  }
  __syncthreads();

  // ---- 3. digest: one thread a lane ------------------------------------
  for (int lane = tid; lane < nr * 6; lane += THREADS) {
    const uint8_t* a = s_aa + lane * P;
    const long long o = ((long long)r0 * 6 + lane) * F;
    digest_lane([&](int j) -> int { return a[j]; }, s_ncod[lane], F, min_len,
                max_len, h1 + o, h2 + o, valid + o);
  }
}

// One thread a lane: the same values as the tile kernel, each codon
// translated from the read in global memory.
__global__ void reads_to_peptides_direct(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L,
    const uint8_t* __restrict__ lut, int32_t* __restrict__ h1,
    int32_t* __restrict__ h2, uint8_t* __restrict__ valid, int F,
    int min_len, int max_len) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)n_reads * 6) return;
  const long long r = lane / 6;
  const int f = (int)(lane - r * 6);
  const int off = f < 3 ? f : f - 3;
  const int len = clamp_len(lengths[r], L);
  const int ncod = (len - off > 0 ? len - off : 0) / 3;
  const uint8_t* row = reads + r * row_bytes;
  auto code = [&](int i) -> int {
    const int x = packed ? (row[i >> 1] >> ((i & 1) ? 0 : 4)) & 0xF : row[i];
    return min(x, 4);
  };
  auto comp = [](int c) { return c < 4 ? 3 - c : 4; };
  auto residue = [&](int j) -> int {
    int codon;
    if (f < 3) {
      const int p = off + 3 * j;
      codon = code(p) * 25 + code(p + 1) * 5 + code(p + 2);
    } else {
      const int p = len - 1 - off - 3 * j;
      codon = comp(code(p)) * 25 + comp(code(p - 1)) * 5 + comp(code(p - 2));
    }
    return lut[codon];
  };
  const long long o = lane * F;
  digest_lane(residue, ncod, F, min_len, max_len, h1 + o, h2 + o, valid + o);
}

constexpr int kSmemMax = 227 * 1024;

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R: reads per block (a power of 2), halved for long reads. lut: the
// 125-entry AA table of the genetic code over codons n0*25 + n1*5 + n2.
extern "C" int reads_to_peptides(const void* reads, int row_bytes, int packed,
                                 const void* lengths, int n_reads, int L,
                                 const void* lut, void* h1, void* h2,
                                 void* valid, int F, int min_len, int max_len,
                                 int R, void* stream) {
  if (n_reads <= 0) return 0;
  if (R < 1 || (R & (R - 1)) || F < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int P = L / 3;
  while (R > 1 && smem_bytes(R, row_bytes, packed, P) > 48 * 1024) R /= 2;
  const size_t smem = (size_t)smem_bytes(R, row_bytes, packed, P);
  if (smem > (size_t)kSmemMax) {
    const long long n = (long long)n_reads * 6;
    reads_to_peptides_direct<<<(unsigned)((n + THREADS - 1) / THREADS),
                               THREADS, 0, s>>>(
        (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
        n_reads, L, (const uint8_t*)lut, (int32_t*)h1, (int32_t*)h2,
        (uint8_t*)valid, F, min_len, max_len);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reads_to_peptides_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_reads + R - 1) / R;
  reads_to_peptides_kernel<<<blocks, THREADS, smem, s>>>(
      (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
      n_reads, L, (const uint8_t*)lut, (int32_t*)h1, (int32_t*)h2,
      (uint8_t*)valid, F, min_len, max_len, R);
  return (int)cudaGetLastError();
}

extern "C" int reads_to_peptides_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return reads_to_peptides(a.ptr(0), (int)a.i(1), (int)a.i(2), a.ptr(3),
                           (int)a.i(4), (int)a.i(5), a.ptr(6), a.ptr(7),
                           a.ptr(8), a.ptr(9), (int)a.i(10), (int)a.i(11),
                           (int)a.i(12), (int)a.i(13), a.ptr(14));
}
