// K1 reads_to_kmers: packed DNA reads -> six-frame 9-mer keys; and its
// protein entry K1P proteins_to_kmers (at the end): AA codes -> 9-mer keys.
//
// Replaces, fused into one pass, three stages of the JAX program
// (umgap_tpu/pipeline/fused.py:149-153):
//   umgap_tpu/ops/encoding.py:57  unpack_dna4_device  (4-bit wire -> codes)
//   umgap_tpu/ops/translate.py:88 translate6_batch    (six-frame translation)
//   umgap_tpu/ops/kmers.py:76     pack_windows_batch  (k-window packing)
// The TPU version materialises the codes, the (B, 6, P) peptides and the
// shifted slices in HBM; here nothing but the packed reads and the outputs
// touches device memory.
//
// Bound on the H100: bytes. Per read the kernel reads L/2 + 4 bytes and
// writes 6 * (W * 9 + 4) bytes (hi, lo int32, valid bool, plen int32):
// 80 MB of stores against 2.6 MB of loads for a 32,768-read batch at
// L = 160. The arithmetic (a table lookup per codon, a shift per window)
// is far below the integer peak.
//
// Design: the TPU-shaped version (one thread per (read, frame) lane,
// walking its codons with byte loads and writing its own row of W
// windows) issued every store 100-180 bytes from its neighbour's. Here
// the stores are written in memory order. One block owns R consecutive
// reads, whose R * 6 * W outputs of each kind are one contiguous span,
// and works in phases over shared memory:
//   1. load: the block's R * row_bytes span of the packed reads (one
//      contiguous run) with 16-byte loads, the ragged head and tail of an
//      unaligned span with byte loads; per (read, frame) lane its codon
//      count and where its codons start; then the codes, unpacked once
//      a base (not once a codon per frame);
//   2. translate: one thread per (read, frame, residue) writes the
//      residue code into aa[R][6][NRES] (NRES = W + k - 1), stepping its
//      (lane, residue) index without a division;
//   3. pack and store: one thread per eight consecutive outputs of the
//      span builds the keys from aa (the first from k residues, the next
//      by one shift each) and stores eight hi and eight lo as two 16-byte
//      stores each and eight valid flags as one 8-byte store, so a warp
//      writes 1 KB + 1 KB + 256 contiguous bytes.
// R is a multiple of 4, so every block's output span starts on an
// 8-element boundary. W and k are template constants for the main widths
// (W = 25 and 45 at k = 9, L = 100 and 160), which turns the divisions by
// NRES and W into multiply-shifts; other widths take the runtime-width
// instance. R = 32 reads a block (256 threads, 19 KB of shared memory
// at L = 160) came out of a sweep over R = 8, 16, 32, 64 on the H100
// (chip_smoke.py block_sweep; PERF.md, section 6): 8 and 16 leave too
// little work between a block's barriers, 64 too few blocks an SM. Long
// reads halve R to keep a block within 48 KB (launch, below).
//
// Reads too long for the tile even at R = 4 (a block needs about 14 bytes
// of shared memory a base: above about 16.6 kb it exceeds the 227 KB a
// block may hold) take the direct kernel: one thread an output window,
// which unpacks and translates its k codons straight from the packed
// read in global memory (L1/L2; neighbouring threads share most of
// them). A simple path: each base is read k times.
//
// Semantics held exactly (tests hold the plain version to the JAX
// functions, chip_smoke.py holds this kernel to the plain version):
// - codes above 4 (the odd-length pad nibble included) read as N;
// - the reverse strand uses the read's own length:
//   rc[i] = comp(dna[len - 1 - i]), comp(N) = N;
// - frame f has ncod = max(len - f % 3, 0) / 3 codons; residues at
//   j >= ncod are AA_PAD (31); a peptide shorter than k is padded with 0
//   up to k, so its single window is packed but invalid;
// - the methionine flag turns every start codon of the table into M;
// - window w is valid iff w < ncod - (k - 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int AA_PAD = 31;
constexpr int AA_M = 12;  // 'M'
constexpr int THREADS = 256;

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// Shared memory of one block: [packed span + 16 | ncod R*6 | base R*6 |
// lut 256 | codes R*LP | aa R*6*NRES], LP codes a read.
__host__ __device__ __forceinline__ int smem_bytes(int R, int row_bytes,
                                                   int packed, int nres) {
  const int lp = packed ? 2 * row_bytes : row_bytes;
  return align16(R * row_bytes + 16) + 2 * 4 * 6 * R + 256 +
         align16(R * lp) + R * 6 * nres;
}

// Phase 3's store: the n <= 8 consecutive outputs from o (a multiple of
// 8 when n == 8) as two 16-byte stores of hi, two of lo and one 8-byte
// store of the valid flags (byte e of vb[e / 4] at bits 8 * (e % 4)), or
// one by one for a ragged end.
__device__ __forceinline__ void store_outputs(
    int32_t* __restrict__ hi, int32_t* __restrict__ lo,
    uint8_t* __restrict__ valid, long long o, const int32_t (&h)[8],
    const int32_t (&l)[8], const uint32_t (&vb)[2], int n) {
  if (n == 8) {
    int4* hv = (int4*)(hi + o);
    int4* lv = (int4*)(lo + o);
    hv[0] = make_int4(h[0], h[1], h[2], h[3]);
    hv[1] = make_int4(h[4], h[5], h[6], h[7]);
    lv[0] = make_int4(l[0], l[1], l[2], l[3]);
    lv[1] = make_int4(l[4], l[5], l[6], l[7]);
    *(uint2*)(valid + o) = make_uint2(vb[0], vb[1]);
  } else {
    for (int e = 0; e < n; ++e) {
      hi[o + e] = h[e];
      lo[o + e] = l[e];
      valid[o + e] = (uint8_t)(vb[e >> 2] >> (8 * (e & 3)));
    }
  }
}

// WT, KT: the output width W and k as constants, or 0 for the runtime
// values W_rt, k_rt.
template <int WT, int KT>
__global__ void __launch_bounds__(THREADS) reads_to_kmers_kernel(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L, int k_rt,
    int methionine, const uint8_t* __restrict__ lut,
    int32_t* __restrict__ hi, int32_t* __restrict__ lo,
    uint8_t* __restrict__ valid, int32_t* __restrict__ plens, int W_rt,
    int R) {
  const int W = WT ? WT : W_rt;
  const int k = KT ? KT : k_rt;
  const int NRES = W + k - 1;  // P when P >= k, else k (zero padded)
  const int P = L / 3;
  const int LP = packed ? 2 * row_bytes : row_bytes;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_dna = smem;
  int32_t* s_ncod = (int32_t*)(smem + align16(R * row_bytes + 16));
  int32_t* s_base = s_ncod + 6 * R;
  uint8_t* s_lut = (uint8_t*)(s_base + 6 * R);
  uint8_t* s_code = s_lut + 256;
  uint8_t* s_aa = s_code + align16(R * LP);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, n_reads - r0);

  // ---- 1. load --------------------------------------------------------
  // lut[0..124]: AA code per codon; lut[128..252]: start-codon flags
  for (int i = tid; i < 256; i += THREADS) s_lut[i] = lut[i];
  // per (read, frame) lane: its codons, and where its first codon
  // starts in the read's codes (~start on the reverse strand, which
  // walks back from the read's own last base)
  for (int i = tid; i < nr * 6; i += THREADS) {
    const int r = i / 6, f = i - r * 6;
    const int off = f < 3 ? f : f - 3;
    int len = lengths[r0 + r];
    len = len < 0 ? 0 : (len > L ? L : len);
    const int ncod = (len - off > 0 ? len - off : 0) / 3;
    s_ncod[i] = ncod;
    s_base[i] = f < 3 ? r * LP + off : ~(r * LP + len - 1 - off);
    plens[(long long)r0 * 6 + i] = ncod;
  }
  // byte i of the span lands at s_dna[head + i]: the span's aligned
  // 16-byte chunks land on aligned shared addresses
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

  // the codes, once a base: codes above 4 read as N (4). Read r's code
  // i is s_code[r * LP + i] (a packed byte holds codes 2b and 2b + 1)
  if (packed) {
    for (int b = tid; b < span; b += THREADS) {
      const int x = sd[b];
      const int c0 = min(x >> 4, 4), c1 = min(x & 0xF, 4);
      *(uint16_t*)(s_code + 2 * b) = (uint16_t)(c0 | (c1 << 8));
    }
  } else {
    for (int b = tid; b < span; b += THREADS) s_code[b] = min((int)sd[b], 4);
  }
  __syncthreads();

  // ---- 2. translate: item it = (lane, j), lane = it / NRES ------------
  const int n_items = nr * 6 * NRES;
  {
    int lane = tid / NRES;
    int j = tid - lane * NRES;
    const int dl = THREADS / NRES, dj = THREADS - dl * NRES;
    for (int it = tid; it < n_items; it += THREADS) {
      const int ncod = s_ncod[lane];
      int aa;
      if (j >= P) {
        aa = 0;
      } else if (j >= ncod) {
        aa = AA_PAD;
      } else {
        const int base = s_base[lane];
        int codon;
        if (base >= 0) {
          const uint8_t* c = s_code + base + 3 * j;
          codon = c[0] * 25 + c[1] * 5 + c[2];
        } else {  // complement: 3 - c for A, C, G, T; N stays N
          const uint8_t* c = s_code + ~base - 3 * j;
          const int c0 = c[0], c1 = c[-1], c2 = c[-2];
          codon = (c0 < 4 ? 3 - c0 : 4) * 25 + (c1 < 4 ? 3 - c1 : 4) * 5 +
                  (c2 < 4 ? 3 - c2 : 4);
        }
        aa = s_lut[codon];
        if (methionine && s_lut[128 + codon]) aa = AA_M;
      }
      s_aa[it] = (uint8_t)aa;
      j += dj;
      lane += dl;
      if (j >= NRES) {
        j -= NRES;
        ++lane;
      }
    }
  }
  __syncthreads();

  // ---- 3. pack and store, in memory order: 8 outputs a thread --------
  const int n_lo = k < 5 ? k : 5;
  const uint64_t key_mask = (1ull << (5 * k)) - 1;  // k <= 10
  const uint64_t lo_mask = (1ull << (5 * n_lo)) - 1;
  const int n_out = nr * 6 * W;
  const long long o0 = (long long)r0 * 6 * W;  // a multiple of 8: R % 4 == 0
  for (int q = tid * 8; q < n_out; q += THREADS * 8) {
    int lane = q / W;
    int w = q - lane * W;
    int32_t h[8], l[8];
    uint32_t vb[2] = {0, 0};
    uint64_t key = 0;
    int n_valid = 0;
    const int n = min(8, n_out - q);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e < n) {
        if (e == 0 || w == 0) {
          const uint8_t* a = s_aa + lane * NRES + w;
          key = 0;
          for (int i = 0; i < k; ++i) key = (key << 5) | a[i];
          n_valid = s_ncod[lane] - (k - 1);
        } else {
          key = ((key << 5) | s_aa[lane * NRES + w + k - 1]) & key_mask;
        }
        h[e] = (int32_t)(key >> (5 * n_lo));
        l[e] = (int32_t)(key & lo_mask);
        vb[e >> 2] |= (uint32_t)(w < n_valid) << (8 * (e & 3));
        if (++w == W) {
          w = 0;
          ++lane;
        }
      }
    }
    store_outputs(hi, lo, valid, o0 + q, h, l, vb, n);
  }
}

// One thread an output (read, frame, window): the same values as the
// tile kernel, each residue computed from the packed read.
__global__ void reads_to_kmers_direct(
    const uint8_t* __restrict__ reads, int row_bytes, int packed,
    const int32_t* __restrict__ lengths, int n_reads, int L, int k,
    int methionine, const uint8_t* __restrict__ lut,
    int32_t* __restrict__ hi, int32_t* __restrict__ lo,
    uint8_t* __restrict__ valid, int32_t* __restrict__ plens, int W) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)n_reads * 6 * W) return;
  const long long lane = q / W;
  const int w = (int)(q - lane * W);
  const long long r = lane / 6;
  const int f = (int)(lane - r * 6);
  const int off = f < 3 ? f : f - 3;
  int len = lengths[r];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int ncod = (len - off > 0 ? len - off : 0) / 3;
  if (w == 0) plens[lane] = ncod;
  const int P = L / 3;
  const uint8_t* row = reads + r * row_bytes;
  auto code = [&](int i) -> int {
    const int x = packed ? (row[i >> 1] >> ((i & 1) ? 0 : 4)) & 0xF : row[i];
    return min(x, 4);
  };
  auto comp = [](int c) { return c < 4 ? 3 - c : 4; };
  uint64_t key = 0;
  for (int i = 0; i < k; ++i) {
    const int j = w + i;
    int aa;
    if (j >= P) {
      aa = 0;
    } else if (j >= ncod) {
      aa = AA_PAD;
    } else {
      int codon;
      if (f < 3) {
        const int p = off + 3 * j;
        codon = code(p) * 25 + code(p + 1) * 5 + code(p + 2);
      } else {  // the reverse strand walks back from the read's last base
        const int p = len - 1 - off - 3 * j;
        codon = comp(code(p)) * 25 + comp(code(p - 1)) * 5 +
                comp(code(p - 2));
      }
      aa = lut[codon];
      if (methionine && lut[128 + codon]) aa = AA_M;
    }
    key = (key << 5) | (uint64_t)aa;
  }
  const int n_lo = k < 5 ? k : 5;
  hi[q] = (int32_t)(key >> (5 * n_lo));
  lo[q] = (int32_t)(key & ((1ull << (5 * n_lo)) - 1));
  valid[q] = (uint8_t)(w < ncod - (k - 1));
}

// the most dynamic shared memory a block may hold
constexpr int kSmemMax = 227 * 1024;

template <int WT, int KT>
int launch(const void* reads, int row_bytes, int packed, const void* lengths,
           int n_reads, int L, int k, int methionine, const void* lut,
           void* hi, void* lo, void* valid, void* plens, int W, int R,
           cudaStream_t stream) {
  // long reads: halve R (down to 4) to keep a block within 48 KB, then
  // opt in to more
  while (R > 4 && smem_bytes(R, row_bytes, packed, W + k - 1) > 48 * 1024)
    R /= 2;
  const size_t smem = (size_t)smem_bytes(R, row_bytes, packed, W + k - 1);
  if (smem > (size_t)kSmemMax) {  // too long for the tile: direct kernel
    const long long n = (long long)n_reads * 6 * W;
    reads_to_kmers_direct<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                            0, stream>>>(
        (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
        n_reads, L, k, methionine, (const uint8_t*)lut, (int32_t*)hi,
        (int32_t*)lo, (uint8_t*)valid, (int32_t*)plens, W);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reads_to_kmers_kernel<WT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_reads + R - 1) / R;
  reads_to_kmers_kernel<WT, KT><<<blocks, THREADS, smem, stream>>>(
      (const uint8_t*)reads, row_bytes, packed, (const int32_t*)lengths,
      n_reads, L, k, methionine, (const uint8_t*)lut, (int32_t*)hi,
      (int32_t*)lo, (uint8_t*)valid, (int32_t*)plens, W, R);
  return (int)cudaGetLastError();
}

// ---- K1P proteins_to_kmers -------------------------------------------
// Replaces umgap_tpu/ops/kmers.py:76 pack_windows_batch on the protein
// path (umgap_tpu/pipeline/proteins.py:33, FGSpp's predicted genes; the
// TSV split of buildindex-dist, index/scale.py; prot2kmer2lca): the TPU
// version builds each key from k shifted slices of the batch, about 20
// PyTorch launches here. Bound on the H100: bytes. Per lane it reads
// P + 4 bytes and writes 9 * W (hi, lo int32, valid bool): at the CLI's
// gene batch (4,096 lanes of P = 64) 0.26 MB in and 2.1 MB out, under a
// microsecond at the HBM rate, so one launch's own cost dominates; the
// split's batches of 8,392 proteins of up to 1,999 residues write 151 MB
// each.
//
// What held the first design (one block of R whole lanes, one window
// folded from k byte loads of shared memory) back: R lanes a block made
// the gene batch 128 blocks, under one an SM, and wide proteins (past
// ~29,000 residues) a direct kernel reading every residue k times; the
// byte loads (72 a thread, 2-way bank conflicts), a division a step, and
// a load phase that never overlapped the packing.
//
// Design: the outputs, flattened (lane * W + w), are cut into tiles of
// `tile` windows (a multiple of 8, up to 2,048), one a block; the wrapper
// sizes the tile so that a call makes at least two blocks an SM where it
// can (ops/kmers.py k1p_plan). Output o = lane * W + w reads residues
// lane * P + w .. + k - 1, so a tile's windows read one contiguous run
// of the batch: from its first window's first residue to its last
// window's last, which is the run plus k - 1 residues a lane piece. The
// block copies that run into shared memory with 16-byte loads (the
// ragged ends by bytes); every lane width is tiled (no direct kernel).
// A warp packs 256 consecutive windows of the tile, a thread two runs of
// 4 of them 128 windows apart, so that each of the warp's 16-byte stores
// of hi and lo, and 4-byte stores of the valid flags, covers 512 (128)
// consecutive bytes; a thread's lane and window come from the tile's by
// a small division. At k = 9 with W >= 4 and a 4-byte aligned batch (the
// main paths), output o's first residue lies 8 * lane past o, so a
// run's first residue is 4-byte aligned in the copy: the thread reads
// the 20 bytes its 4 windows can span (a lane edge among them moves the
// later windows on by k - 1 = 8 bytes, two 4-byte words) with five
// 4-byte shared loads and folds each window from registers. Other
// shapes (k != 9, W < 4, an unaligned batch) fold each window from k
// byte loads of the run. A window is folded from its k residues (hi: the
// first k - 5, lo: the last 5), never rolled, so codes above 31 give the
// plain version's bits too; residues past P read as 0 (a batch with P <
// k has one window a lane, zero padded and invalid).
//
// Swept on the H100 (chip_smoke.py redesign_sweep; PERF.md section 6):
// a thread's 8 consecutive windows (store_outputs' pattern, two 16-byte
// stores 32 bytes apart a thread) took 0.366 ms on the build's TSV split
// against 0.258 for runs of 4; a persistent grid whose blocks copy the
// next tile with cp.async while packing this one (2 stage buffers, 4 or
// 8 blocks an SM) took 0.266-0.272, so a block takes one tile; tiles of
// at most 512 or 1,024 windows took 0.247, of 2,048 0.256.

// windows a tile at most
constexpr int kTileMax = 2048;

// Bytes of a tile's stage buffer: its run of residues (at most tile - 1 +
// (k - 1) * (lane edges crossed + 1) + k), the 16-byte alignment head
// before it and the fast path's read past its end.
inline int k1p_stage_bytes(int tile, int W, int k) {
  return align16(tile - 1 + (k - 1) * ((tile - 1) / W + 1) + k + 15 + 32);
}

// (x / W, x % W) of a window count, by a 32-bit division where x fits
struct LaneWin {
  long long lane;
  int w;
};

__device__ __forceinline__ LaneWin lane_win(long long x, int W) {
  if (x <= 0x7FFFFFFFLL) {
    const unsigned q = (unsigned)x / (unsigned)W;
    return LaneWin{(long long)q, (int)((unsigned)x - q * (unsigned)W)};
  }
  const long long q = x / W;
  return LaneWin{q, (int)(x - q * W)};
}

// KT: k as a constant (9) or 0 for k_rt. FAST: k = 9, W >= 4 and a
// 4-byte aligned batch (see the note above).
template <int KT, bool FAST>
__global__ void __launch_bounds__(THREADS) proteins_to_kmers_kernel(
    const uint8_t* __restrict__ aa, int P,
    const int32_t* __restrict__ lengths, int n_lanes, int k_rt,
    int32_t* __restrict__ hi, int32_t* __restrict__ lo,
    uint8_t* __restrict__ valid, int W, int tile) {
  const int k = KT ? KT : k_rt;
  const int kp = k < P ? k : P;  // residues of a lane's last window
  const int n_hi = k - (k < 5 ? k : 5);
  extern __shared__ __align__(16) uint8_t smem[];
  const long long n_out = (long long)n_lanes * W;
  const long long o0 = (long long)blockIdx.x * tile;  // the tile's windows
  const long long o1 = min(o0 + tile, n_out);
  const int tid = threadIdx.x;

  // ---- the tile's run: residues [first, end) ---------------------------
  const LaneWin ts = lane_win(o0, W), te = lane_win(o1 - 1, W);
  const long long first = ts.lane * P + ts.w;
  const long long end = te.lane * P + te.w + kp;
  {
    const uint8_t* g0 = aa + first;
    const int n = (int)(end - first);
    const int head = (int)((uintptr_t)g0 & 15);
    const int lead = min((16 - head) & 15, n);
    const int nvec = (n - lead) >> 4;
    const int tail0 = lead + (nvec << 4);
    uint8_t* sd = smem + head;  // byte i of the run at smem[head + i]
    if (tid < lead) sd[tid] = g0[tid];
    const uint4* gv = (const uint4*)(g0 + lead);
    uint4* sv = (uint4*)(sd + lead);
    for (int v = tid; v < nvec; v += blockDim.x) sv[v] = __ldg(gv + v);
    for (int i = tail0 + tid; i < n; i += blockDim.x) sd[i] = g0[i];
  }
  __syncthreads();
  const uint8_t* run = smem + (int)((uintptr_t)(aa + first) & 15);

  // ---- pack and store: two runs of 4 windows a thread ------------------
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int off = 256 * (tid >> 5) + 128 * j + 4 * (tid & 31);
    const long long q = o0 + off;  // the run's first window
    if (q >= o1) continue;
    const int n = (int)min(4LL, o1 - q);
    // its (lane, window): the tile's first, moved on by off < 2,048
    LaneWin me = ts;
    {
      const int dl = off / W, dw = off - dl * W;
      me.lane += dl;
      me.w += dw;
      if (me.w >= W) {
        me.w -= W;
        ++me.lane;
      }
    }
    int32_t h[4], l[4];
    uint32_t vb = 0;
    if constexpr (FAST) {
      // bytes 0..19 from the run's first residue: u[0..5)
      const uint32_t* p = (const uint32_t*)(run + (me.lane * P + me.w - first));
      uint32_t u[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) u[i] = p[i];
      const int left = W - me.w;  // windows before the lane edge
      const long long n0 = (long long)lengths[me.lane] - 8;
      const long long n1 = (left < n && me.lane + 1 < n_lanes)
                               ? (long long)lengths[me.lane + 1] - 8
                               : 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool next = e >= left;  // in the next lane: 8 bytes on
        uint32_t sw[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) sw[i] = next ? u[i + 2] : u[i];
        uint32_t kh = 0, kl = 0;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const int x = e + i;
          const uint32_t c8 = (sw[x >> 2] >> (8 * (x & 3))) & 0xFFu;
          if (i < 4)
            kh |= c8 << (5 * (3 - i));
          else
            kl |= c8 << (5 * (8 - i));
        }
        h[e] = (int32_t)kh;
        l[e] = (int32_t)kl;
        const int wi = next ? e - left : me.w + e;
        vb |= (uint32_t)(wi < (next ? n1 : n0)) << (8 * e);
      }
    } else {
      long long lane = me.lane;
      int w = me.w;
      long long n_valid = (long long)lengths[lane] - (k - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < n) {
          const uint8_t* a = run + (lane * P + w - first);
          uint32_t kh = 0, kl = 0;
          for (int i = 0; i < k; ++i) {
            const uint32_t c = w + i < P ? a[i] : 0u;
            if (i < n_hi)
              kh = (kh << 5) | c;
            else
              kl = (kl << 5) | c;
          }
          h[e] = (int32_t)kh;
          l[e] = (int32_t)kl;
          vb |= (uint32_t)(w < n_valid) << (8 * e);
          if (++w == W && e + 1 < n) {
            w = 0;
            ++lane;
            n_valid = (long long)lengths[lane] - (k - 1);
          }
        }
      }
    }
    if (n == 4) {  // q % 4 == 0: 16-byte aligned
      *(int4*)(hi + q) = make_int4(h[0], h[1], h[2], h[3]);
      *(int4*)(lo + q) = make_int4(l[0], l[1], l[2], l[3]);
      *(uint32_t*)(valid + q) = vb;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < n) {
          hi[q + e] = h[e];
          lo[q + e] = l[e];
          valid[q + e] = (uint8_t)(vb >> (8 * e));
        }
      }
    }
  }
}

template <int KT, bool FAST>
int launch_proteins(const void* aa, int P, const void* lengths, int n_lanes,
                    int k, void* hi, void* lo, void* valid, int W, int tile,
                    cudaStream_t stream) {
  const size_t smem = (size_t)k1p_stage_bytes(tile, W, k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        proteins_to_kmers_kernel<KT, FAST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)n_lanes * W + tile - 1) / tile;
  const int threads = (tile + 255) / 256 * 32;  // a warp a 256 windows
  proteins_to_kmers_kernel<KT, FAST><<<(unsigned)blocks, threads, smem,
                                       stream>>>(
      (const uint8_t*)aa, P, (const int32_t*)lengths, n_lanes, k,
      (int32_t*)hi, (int32_t*)lo, (uint8_t*)valid, W, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R: reads per block, a power of 2 from 4 (the output spans then start
// on 8 elements; hi, lo and valid must be allocations of their own),
// halved for long reads.
extern "C" int reads_to_kmers(const void* reads, int row_bytes, int packed,
                              const void* lengths, int n_reads, int L, int k,
                              int methionine, const void* lut, void* hi,
                              void* lo, void* valid, void* plens, int W,
                              int R, void* stream) {
  if (n_reads <= 0) return 0;
  if (R < 4 || (R & (R - 1)) || k < 1 || k > 10)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 9 && W == 25)
    return launch<25, 9>(reads, row_bytes, packed, lengths, n_reads, L, k,
                         methionine, lut, hi, lo, valid, plens, W, R, s);
  if (k == 9 && W == 45)
    return launch<45, 9>(reads, row_bytes, packed, lengths, n_reads, L, k,
                         methionine, lut, hi, lo, valid, plens, W, R, s);
  return launch<0, 0>(reads, row_bytes, packed, lengths, n_reads, L, k,
                      methionine, lut, hi, lo, valid, plens, W, R, s);
}

extern "C" int reads_to_kmers_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return reads_to_kmers(a.ptr(0), (int)a.i(1), (int)a.i(2), a.ptr(3),
                        (int)a.i(4), (int)a.i(5), (int)a.i(6), (int)a.i(7),
                        a.ptr(8), a.ptr(9), a.ptr(10), a.ptr(11), a.ptr(12),
                        (int)a.i(13), (int)a.i(14), a.ptr(15));
}

// K1P: AA codes (n_lanes, P) uint8 and lengths (n_lanes,) int32 -> hi, lo
// (n_lanes, W) int32 and valid (n_lanes, W) bool, W = max(P - k + 1, 1).
// tile: windows a block, a multiple of 8 up to 2,048 (hi, lo and valid
// must be allocations of their own; ops/kmers.py k1p_plan).
extern "C" int proteins_to_kmers(const void* aa, int P, const void* lengths,
                                 int n_lanes, int k, void* hi, void* lo,
                                 void* valid, int W, int tile, void* stream) {
  if (n_lanes <= 0) return 0;
  if (tile < 8 || tile > kTileMax || (tile & 7) || k < 1 || k > 10 ||
      P < 1 || W != (P - k + 1 > 1 ? P - k + 1 : 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 9 && W >= 4 && ((uintptr_t)aa & 3) == 0)
    return launch_proteins<9, true>(aa, P, lengths, n_lanes, k, hi, lo,
                                    valid, W, tile, s);
  if (k == 9)
    return launch_proteins<9, false>(aa, P, lengths, n_lanes, k, hi, lo,
                                     valid, W, tile, s);
  return launch_proteins<0, false>(aa, P, lengths, n_lanes, k, hi, lo, valid,
                                   W, tile, s);
}

extern "C" int proteins_to_kmers_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return proteins_to_kmers(a.ptr(0), (int)a.i(1), a.ptr(2), (int)a.i(3),
                           (int)a.i(4), a.ptr(5), a.ptr(6), a.ptr(7),
                           (int)a.i(8), (int)a.i(9), a.ptr(10));
}
