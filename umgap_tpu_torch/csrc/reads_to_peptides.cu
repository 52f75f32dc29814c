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
// writes 6 * F * 9 bytes (h1, h2 int32, valid bool), F = (L / 3) / 9 + 1:
// 8.8 MB for a 32,768-read batch at L = 100, 2.6 us at 3.35 TB/s. What
// holds it far above that is the digest's walk: a residue costs its
// table lookup, the fragment tests and two dependent FNV steps, some 33
// SASS instructions a (read, frame, residue), issued by every lane
// (PERF.md, section 6).
//
// Design: a block owns R consecutive reads, and works in phases over
// shared memory, all of its threads busy in each:
//   1. load: the block's R * row_bytes span of the packed reads (one
//      contiguous run) with 16-byte loads (byte loads for an unaligned
//      head and tail), as K1 (csrc/reads_to_kmers.cu), and the lengths;
//   2. translate: one thread a 4-byte group (eight bases) of the span
//      writes, for each of its bases i, the residue of the codon that
//      starts there on the forward strand, faa[i] = flut[c(i) c(i+1)
//      c(i+2)], and of the reverse codon that ends there, raa[i] =
//      rlut[c(i) c(i-1) c(i-2)] (rlut holds the complement's residue).
//      Codon j of forward frame f is faa[off + 3j], of reverse frame f
//      raa[len - 1 - off - 3j]: the span is translated once a base, in
//      all six frames, with no division and no per-read index (a codon
//      that runs into the next read's bases is never used). The tables
//      hold each residue tagged with the digest's tests ('K' or 'R', 'P',
//      '*' as bits 5-7);
//   3. digest: one thread a (read, frame) lane walks its residues once
//      (a shared byte load each, by a pointer step of +-3), keeps the two
//      FNV-1a lanes and the fragment length in registers and writes each
//      emitted fragment to the next of its F slots in a shared staging
//      copy of the block's outputs, (h1, h2) as one 8-byte store; the
//      slots after the last emitted one are 0. The block has 6R threads
//      (rounded up to a warp), so every thread walks a lane;
//   4. store: the block's R * 6 * F slots of h1, h2 and valid are one
//      contiguous span of each output, written in memory order with
//      16-byte stores (4 slots of h1 or h2, 16 flags of valid a store).
// The TPU-shaped first version divided by P for every (lane, residue)
// item, left a quarter of its threads idle in the digest and stored each
// slot 4 bytes at a time, F slots from its neighbour's. A warp a read
// (ballots of member and cleave masks, one lane hashing each emitted
// fragment) was weighed and not taken: a read has only 6 * P = 198
// residues at L = 100 and about 7 fragments, so its hashing pass would
// keep 7 of 32 lanes busy. R = 64 reads a block (384 threads, 30 KB of
// shared memory at L = 100) is the default (pipeline/tryptic.py
// READS_PER_BLOCK, from chip_smoke.py's sweep over 16-128). Long reads
// halve R to keep a block within 48 KB, then opt in to more; reads too
// long for the tile even at R = 1 (about 4.5 bytes of shared memory a
// base: above ~51 kb) take the direct kernel, one thread a lane, which
// translates each codon straight from the packed read in global memory.
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
// - fragments of MIN_LEN..MAX_LEN (9..45) residues are emitted,
//   left-compacted in their order, at most F a lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int AA_STOP = 26;
constexpr int AA_K = 10, AA_R = 17, AA_P = 15;
constexpr uint32_t FNV_OFFSET = 0x811C9DC5u;
constexpr uint32_t FNV_OFFSET2 = 0xCBF29CE4u;
constexpr uint32_t FNV_PRIME = 0x01000193u;
constexpr int MAX_THREADS = 768;  // R <= 128
// the fragment lengths kept (the tryptic presets' -l9 -L45); the entry
// refuses others
constexpr int MIN_LEN = 9, MAX_LEN = 45;

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// Shared memory of one block of R reads: [forward and reverse tables
// 2 x 128 | lengths R | packed span + 16 | faa R*LP + 16 | raa R*LP + 16 |
// (h1, h2) pairs R*6*F | valid R*6*F], LP codes a read. The 16 bytes
// after faa and raa hold a lane's read one residue past its last.
struct Smem {
  int lens, span, faa, raa, h12, valid, total;
  __host__ __device__ Smem(int R, int row_bytes, int packed, int F) {
    const int lp = packed ? 2 * row_bytes : row_bytes;
    const int n_out = R * 6 * F;
    lens = 256;
    span = lens + align16(4 * R);
    faa = span + align16(R * row_bytes + 16);
    raa = faa + align16(R * lp + 16);
    h12 = raa + align16(R * lp + 16);
    valid = h12 + 8 * n_out;
    total = valid + align16(n_out);
  }
};

__host__ __device__ __forceinline__ int block_threads(int R) {
  const int t = (6 * R + 31) & ~31;
  return t < 32 ? 32 : t;
}

// A residue code tagged with the digest's tests: bit 5 'K' or 'R', bit 6
// 'P', bit 7 '*' (not a member). The translation tables hold tagged codes.
__host__ __device__ __forceinline__ int tagged(int a) {
  return a | ((a == AA_K || a == AA_R) << 5) | ((a == AA_P) << 6) |
         ((a == AA_STOP) << 7);
}
constexpr int TAG_KR = 0x20, TAG_P = 0x40, TAG_STOP = 0x80;

// Walk one (read, frame) lane of ncod residues and write its F
// fingerprint slots through emit(slot, h1, h2) and clear(slot). first is
// residue 0's tagged code; next() gives residues 1, 2, ... in turn (its
// value past the last one is not used). A member residue ends its
// fragment when the next residue is no member (a '*' or past the lane's
// end) or when it is K or R and the next is not P; the residue after an
// end or a non-member starts afresh. Every residue is hashed (after a
// non-member the lanes restart anyway) and the tests are bit arithmetic
// on the tags, so the loop has no branch but the rare slot write.
template <typename Next, typename Emit, typename Clear>
__device__ __forceinline__ void digest_lane(int first, Next next, int ncod,
                                            int F, Emit emit, Clear clear) {
  int slot = 0;
  uint32_t h1 = FNV_OFFSET, h2 = FNV_OFFSET2;
  int ln = 0;
  int fresh = 1;  // the previous residue ended a fragment or was none
  int x = first;
  for (int j = 1; j <= ncod; ++j) {
    int nxt = next();
    nxt = j < ncod ? nxt : TAG_STOP;
    h1 = fresh ? FNV_OFFSET : h1;
    h2 = fresh ? FNV_OFFSET2 : h2;
    ln = fresh ? 0 : ln;
    const uint32_t c = (uint32_t)(x & 31);
    h1 = (h1 ^ c) * FNV_PRIME;
    h2 = (h2 ^ (c + 0x9E37u)) * FNV_PRIME;
    ++ln;
    const int member = (~x >> 7) & 1;
    const int end = ((nxt >> 7) | ((x >> 5) & ~(nxt >> 6))) & 1;
    if (member & end & ((unsigned)(ln - MIN_LEN) <= MAX_LEN - MIN_LEN) &
        (slot < F)) {
      emit(slot, h1 == 0xFFFFFFFFu ? 0 : (int32_t)h1, (int32_t)h2);
      ++slot;
    }
    fresh = (member ^ 1) | end;
    x = nxt;
  }
  for (; slot < F; ++slot) clear(slot);
}

__device__ __forceinline__ int clamp_len(int len, int L) {
  return len < 0 ? 0 : (len > L ? L : len);
}

__device__ __forceinline__ int comp(int c) { return c < 4 ? 3 - c : 4; }

__global__ void __launch_bounds__(MAX_THREADS) reads_to_peptides_kernel(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L,
    const uint8_t* __restrict__ lut, int32_t* __restrict__ h1,
    int32_t* __restrict__ h2, uint8_t* __restrict__ valid, int F, int R) {
  const int LP = packed ? 2 * row_bytes : row_bytes;
  const Smem lay(R, row_bytes, packed, F);

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_flut = smem;
  uint8_t* s_rlut = smem + 128;
  int32_t* s_len = (int32_t*)(smem + lay.lens);
  uint8_t* s_dna = smem + lay.span;
  uint8_t* s_faa = smem + lay.faa;
  uint8_t* s_raa = smem + lay.raa;
  int2* s_h12 = (int2*)(smem + lay.h12);
  uint8_t* s_v = smem + lay.valid;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, n_reads - r0);

  // ---- 1. load --------------------------------------------------------
  // tagged residues: of codon n0 n1 n2 (forward), and of the reverse
  // codon ~n0 ~n1 ~n2 read back from a base n0 (reverse)
  for (int i = tid; i < 125; i += nt) {
    const int n0 = i / 25, n1 = i / 5 % 5, n2 = i % 5;
    s_flut[i] = (uint8_t)tagged(lut[i]);
    s_rlut[i] = (uint8_t)tagged(lut[comp(n0) * 25 + comp(n1) * 5 + comp(n2)]);
  }
  for (int r = tid; r < nr; r += nt) s_len[r] = clamp_len(lengths[r0 + r], L);
  // byte i of the span lands at sd[i]: the span's aligned 16-byte chunks
  // land on aligned shared addresses
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
    for (int v = tid; v < nvec; v += nt) sv[v] = __ldg(gv + v);
  }
  for (int i = tail0 + tid; i < span; i += nt) sd[i] = g0[i];
  __syncthreads();

  // ---- 2. translate: every base of the span, both strands --------------
  if (packed) {
    // thread q: packed bytes 4q .. 4q + 3 (codes 8q .. 8q + 7), reading
    // bytes 4q - 1 .. 4q + 4 (N outside the span) -> faa and raa at the
    // eight codes, as two 8-byte stores each
    const int nq = (span + 3) >> 2;
    for (int q = tid; q < nq; q += nt) {
      const int b0 = q << 2;
      int c[12];  // codes 8q - 2 .. 8q + 9
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int b = b0 - 1 + k;
        const int x = b >= 0 && b < span ? sd[b] : 0x44;
        c[2 * k] = min(x >> 4, 4);
        c[2 * k + 1] = min(x & 0xF, 4);
      }
      uint32_t f[2] = {0, 0}, r[2] = {0, 0};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint32_t fa = s_flut[c[t + 2] * 25 + c[t + 3] * 5 + c[t + 4]];
        const uint32_t ra = s_rlut[c[t + 2] * 25 + c[t + 1] * 5 + c[t]];
        f[t >> 2] |= fa << (8 * (t & 3));
        r[t >> 2] |= ra << (8 * (t & 3));
      }
      const int i0 = 2 * b0;
      if (b0 + 4 <= span) {
        *(uint2*)(s_faa + i0) = make_uint2(f[0], f[1]);
        *(uint2*)(s_raa + i0) = make_uint2(r[0], r[1]);
      } else {
        for (int t = 0; t < 2 * (span - b0); ++t) {
          s_faa[i0 + t] = (uint8_t)(f[t >> 2] >> (8 * (t & 3)));
          s_raa[i0 + t] = (uint8_t)(r[t >> 2] >> (8 * (t & 3)));
        }
      }
    }
  } else {
    for (int i = tid; i < span; i += nt) {
      const int cm2 = i >= 2 ? min((int)sd[i - 2], 4) : 4;
      const int cm1 = i >= 1 ? min((int)sd[i - 1], 4) : 4;
      const int c0 = min((int)sd[i], 4);
      const int c1 = i + 1 < span ? min((int)sd[i + 1], 4) : 4;
      const int c2 = i + 2 < span ? min((int)sd[i + 2], 4) : 4;
      s_faa[i] = s_flut[c0 * 25 + c1 * 5 + c2];
      s_raa[i] = s_rlut[c0 * 25 + cm1 * 5 + cm2];
    }
  }
  __syncthreads();

  // ---- 3. digest: one thread a (read, frame) lane ----------------------
  const int n_lanes = nr * 6;
  for (int t = tid; t < n_lanes; t += nt) {
    const int r = t / 6, f = t - 6 * r;
    const int off = f < 3 ? f : f - 3;
    const int len = s_len[r];
    const int ncod = (len - off > 0 ? len - off : 0) / 3;
    const int step = f < 3 ? 3 : -3;
    const uint8_t* a = f < 3 ? s_faa + r * LP + off
                             : s_raa + r * LP + (len - 1 - off);
    int2* o12 = s_h12 + t * F;
    uint8_t* ov = s_v + t * F;
    digest_lane(
        ncod > 0 ? (int)*a : TAG_STOP,
        [&]() -> int {
          a += step;
          return *a;
        },
        ncod, F,
        [&](int k, int32_t x1, int32_t x2) {
          o12[k] = make_int2(x1, x2);
          ov[k] = 1;
        },
        [&](int k) {
          o12[k] = make_int2(0, 0);
          ov[k] = 0;
        });
  }
  __syncthreads();

  // ---- 4. store the block's slots in memory order ----------------------
  const int n_out = n_lanes * F;
  const long long o0 = (long long)r0 * 6 * F;
  int32_t* g1 = h1 + o0;
  int32_t* g2 = h2 + o0;
  uint8_t* gv = valid + o0;
  int done32 = 0, done8 = 0;
  if ((((uintptr_t)g1 | (uintptr_t)g2) & 15) == 0) {
    const int n4 = n_out >> 2;
    for (int i = tid; i < n4; i += nt) {
      const int4 a = ((const int4*)s_h12)[2 * i];
      const int4 b = ((const int4*)s_h12)[2 * i + 1];
      ((int4*)g1)[i] = make_int4(a.x, a.z, b.x, b.z);
      ((int4*)g2)[i] = make_int4(a.y, a.w, b.y, b.w);
    }
    done32 = n4 << 2;
  }
  if (((uintptr_t)gv & 15) == 0) {
    const int n16 = n_out >> 4;
    for (int i = tid; i < n16; i += nt)
      ((uint4*)gv)[i] = ((const uint4*)s_v)[i];
    done8 = n16 << 4;
  }
  for (int i = done32 + tid; i < n_out; i += nt) {
    g1[i] = s_h12[i].x;
    g2[i] = s_h12[i].y;
  }
  for (int i = done8 + tid; i < n_out; i += nt) gv[i] = s_v[i];
}

// One thread a lane: the same values as the tile kernel, each codon
// translated from the read in global memory.
__global__ void reads_to_peptides_direct(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L,
    const uint8_t* __restrict__ lut, int32_t* __restrict__ h1,
    int32_t* __restrict__ h2, uint8_t* __restrict__ valid, int F) {
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
  auto residue = [&](int j) -> int {
    int codon;
    if (f < 3) {
      const int p = off + 3 * j;
      codon = code(p) * 25 + code(p + 1) * 5 + code(p + 2);
    } else {
      const int p = len - 1 - off - 3 * j;
      codon = comp(code(p)) * 25 + comp(code(p - 1)) * 5 + comp(code(p - 2));
    }
    return tagged(lut[codon]);
  };
  int j = 0;
  const long long o = lane * F;
  digest_lane(
      ncod > 0 ? residue(0) : TAG_STOP,
      [&]() -> int {
        ++j;
        return j < ncod ? residue(j) : TAG_STOP;
      },
      ncod, F,
      [&](int k, int32_t x1, int32_t x2) {
        h1[o + k] = x1;
        h2[o + k] = x2;
        valid[o + k] = 1;
      },
      [&](int k) {
        h1[o + k] = 0;
        h2[o + k] = 0;
        valid[o + k] = 0;
      });
}

constexpr int kSmemMax = 227 * 1024;
constexpr int kDirectThreads = 256;

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R: reads per block (1..128), halved for long reads. lut: the 125-entry
// AA table of the genetic code over codons n0*25 + n1*5 + n2. min_len,
// max_len: must be MIN_LEN, MAX_LEN.
extern "C" int reads_to_peptides(const void* reads, int row_bytes, int packed,
                                 const void* lengths, int n_reads, int L,
                                 const void* lut, void* h1, void* h2,
                                 void* valid, int F, int min_len, int max_len,
                                 int R, void* stream) {
  if (n_reads <= 0) return 0;
  if (R < 1 || block_threads(R) > MAX_THREADS || F < 1 ||
      min_len != MIN_LEN || max_len != MAX_LEN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  while (R > 1 && Smem(R, row_bytes, packed, F).total > 48 * 1024) R /= 2;
  const size_t smem = (size_t)Smem(R, row_bytes, packed, F).total;
  if (smem > (size_t)kSmemMax) {
    const long long n = (long long)n_reads * 6;
    reads_to_peptides_direct<<<(unsigned)((n + kDirectThreads - 1) /
                                          kDirectThreads),
                               kDirectThreads, 0, s>>>(
        (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
        n_reads, L, (const uint8_t*)lut, (int32_t*)h1, (int32_t*)h2,
        (uint8_t*)valid, F);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reads_to_peptides_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_reads + R - 1) / R;
  reads_to_peptides_kernel<<<blocks, block_threads(R), smem, s>>>(
      (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
      n_reads, L, (const uint8_t*)lut, (int32_t*)h1, (int32_t*)h2,
      (uint8_t*)valid, F, R);
  return (int)cudaGetLastError();
}

extern "C" int reads_to_peptides_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return reads_to_peptides(a.ptr(0), (int)a.i(1), (int)a.i(2), a.ptr(3),
                           (int)a.i(4), (int)a.i(5), a.ptr(6), a.ptr(7),
                           a.ptr(8), a.ptr(9), (int)a.i(10), (int)a.i(11),
                           (int)a.i(12), (int)a.i(13), a.ptr(14));
}
