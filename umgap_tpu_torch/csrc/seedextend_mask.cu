// K3 seedextend_mask: per-lane seed-and-extend, as a keep mask or with
// the hit selection fused in.
//
// Replaces umgap_tpu/ops/seedextend.py:118 seedextend_mask_batch, whose
// TPU form is a lax.scan (_scan_seeds, :173) advancing every lane one
// position per step and turning the recorded seed pushes into +1/-1
// deltas and a cumulative sum, and with it the select that follows it in
// the JAX program (umgap_tpu/pipeline/fused.py:107-109,
// jnp.where(keep, taxa, 0)). Each (read, end, frame) lane runs the
// reference's state machine (src/commands/seedextend.rs:96-178,
// transliterated at seedextend.py:30-70) over its W window taxa, keeping
// the realized quirks: the leading-gap branch (b2) that moves the seed
// start past the current position, and the trim of a trailing gap at the
// final flush. Pushes add +1 at their start and -1 at their stop
// (positions outside [0, W) are dropped, as in the scan's one-hot
// deltas) into an int16 delta row in shared memory; the running sum > 0,
// inside the lane's length, is the keep mask. Two epilogues: `hits`
// writes taxa where the lane keeps the window and 0 elsewhere (int32, the
// pipeline's input to dedup; no bool mask and no select pass), else the
// keep mask (bool).
//
// Bound on the H100: bytes. Each lane reads W int32 taxa and its length
// once and writes W int32 hits (or W bools); the state machine is a
// handful of integer selects per position.
//
// Design (the staged kernel, rows of up to 96 windows: reads up to
// 312 bp): one block takes T = 64 consecutive lanes, whose T x W taxa
// are one contiguous span. The block loads it with 16-byte loads into a
// shared tile whose row stride is odd (W, or W + 1 for an even W), so
// that the threads of a warp, one lane each, read their rows without
// bank conflicts; each thread runs the state machine over its row,
// overwrites the row in place with its hits (or keep flags), and the
// block writes the tile back with 16-byte stores (16 bools a thread for
// the mask). T = 64 came out of a sweep over T = 32, 64, 128 on the H100
// (PERF.md, section 6). Wider rows take the direct kernel: one thread a
// lane reading and writing its row in global memory, its delta row in
// shared memory. Rows too wide for one warp's delta rows there (more
// than 3,600 windows: reads from about 10.8 kb) keep the delta rows in a
// global scratch the caller allocates, laid out [N][lanes] so that a
// warp's lanes touch consecutive words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int MAX_T = 128;

// The reference's state machine over one lane: tx(p) is the lane's taxon
// at p (0 at and beyond its length), add(p, v) records a delta.
template <typename Tx, typename Add>
__device__ __forceinline__ void scan_seeds(int N, int s, int g, Tx tx,
                                           Add add) {
  int start = 0, same_tid = 1, same_max = 1;
  int32_t last = tx(0);
  int32_t cur = tx(1);
  for (int end = 1; end <= N; ++end) {
    const int32_t nxt = tx(end + 1);  // loaded one step ahead
    const bool same = last == cur;
    const bool b1 = !same && last == 0 && same_tid > g;
    const bool b2 = !same && !b1 && last == 0 && (end - start) == same_tid;
    const bool b3 = !same && !b1 && !b2;
    if (b1 && same_max >= s) {
      add(start, 1);
      add(end - same_tid, -1);
    }
    const int n_start = b1 ? end : (b2 ? end + 1 : start);
    const int32_t n_last = (same || b2) ? last : cur;
    const int n_same_tid = same ? same_tid + 1 : (b2 ? same_tid : 1);
    const int n_same_max =
        b1 ? 1
           : ((b3 && last != 0) ? (same_max > same_tid ? same_max : same_tid)
                                : same_max);
    start = n_start;
    last = n_last;
    same_tid = n_same_tid;
    same_max = n_same_max;
    cur = nxt;
  }
  if (same_max >= s) {
    const int f_end = N + 1;
    add(start, 1);
    add(last == 0 ? f_end - same_tid : f_end, -1);
  }
}

// NT: the row width W as a constant, or 0 for the runtime N_rt.
template <int NT>
__global__ void __launch_bounds__(MAX_T) seedextend_staged_kernel(
    const int32_t* __restrict__ taxa, const int32_t* __restrict__ lengths,
    long long lanes, int N_rt, int s, int g, void* __restrict__ out,
    int hits, int vec_load) {
  const int N = NT ? NT : N_rt;
  const int S = N | 1;  // odd row stride (words)
  const int T = blockDim.x;
  extern __shared__ __align__(16) int32_t s_tax[];  // [T][S]
  int16_t* s_delta = (int16_t*)(s_tax + T * S);     // [N][T]

  const int tid = threadIdx.x;
  const long long lane0 = (long long)blockIdx.x * T;
  const int nl = (int)min((long long)T, lanes - lane0);
  const int span = nl * N;

  // ---- load the tile: element e of the span -> s_tax[(e / N) * S + e % N]
  const int32_t* g0 = taxa + lane0 * N;
  int nvec = 0;
  if (vec_load) {  // taxa 16-byte aligned; T * N % 4 == 0 (T % 16 == 0)
    nvec = span >> 2;
    const int4* gv = (const int4*)g0;
    for (int v = tid; v < nvec; v += T) {
      const int4 x = __ldg(gv + v);
      const int e = v * 4;
      int r = e / N, c = e - r * N;
      const int32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s_tax[r * S + c] = xs[i];
        if (++c == N) {
          c = 0;
          ++r;
        }
      }
    }
  }
  for (int e = nvec * 4 + tid; e < span; e += T) {
    const int r = e / N;
    s_tax[r * S + (e - r * N)] = g0[e];
  }
  __syncthreads();

  // ---- one lane a thread: the state machine, then the row in place ---
  if (tid < nl) {
    const int len = lengths[lane0 + tid];
    int32_t* row = s_tax + tid * S;
    int16_t* d = s_delta + tid;
    for (int p = 0; p < N; ++p) d[p * T] = 0;
    scan_seeds(
        N, s, g,
        [&](int p) -> int32_t { return (p < N && p < len) ? row[p] : 0; },
        [&](int p, int v) {
          if (p >= 0 && p < N) d[p * T] = (int16_t)(d[p * T] + v);
        });
    int run = 0;
    for (int p = 0; p < N; ++p) {
      run += d[p * T];
      const bool keep = run > 0 && p < len;
      row[p] = hits ? (keep ? row[p] : 0) : (int32_t)keep;
    }
  }
  __syncthreads();

  // ---- write the tile back in memory order ----------------------------
  if (hits) {
    int32_t* o = (int32_t*)out + lane0 * N;  // 16-byte aligned: T % 16 == 0
    const int nv = span >> 2;
    for (int v = tid; v < nv; v += T) {
      const int e = v * 4;
      int r = e / N, c = e - r * N;
      int32_t xs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xs[i] = s_tax[r * S + c];
        if (++c == N) {
          c = 0;
          ++r;
        }
      }
      *(int4*)(o + e) = make_int4(xs[0], xs[1], xs[2], xs[3]);
    }
    for (int e = nv * 4 + tid; e < span; e += T) {
      const int r = e / N;
      o[e] = s_tax[r * S + (e - r * N)];
    }
  } else {
    uint8_t* o = (uint8_t*)out + lane0 * N;  // 16-byte aligned: T % 16 == 0
    const int nv = span >> 4;
    for (int v = tid; v < nv; v += T) {
      const int e = v * 16;
      int r = e / N, c = e - r * N;
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        w[i >> 2] |= (uint32_t)(s_tax[r * S + c] & 1) << (8 * (i & 3));
        if (++c == N) {
          c = 0;
          ++r;
        }
      }
      *(uint4*)(o + e) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (int e = nv * 16 + tid; e < span; e += T) {
      const int r = e / N;
      o[e] = (uint8_t)s_tax[r * S + (e - r * N)];
    }
  }
}

// Rows too wide for the staged tile: one thread a lane on its row in
// global memory, the delta row in shared memory ([N][blockDim]), or in
// the global scratch ([N][lanes]) when one is given.
__global__ void seedextend_direct_kernel(const int32_t* __restrict__ taxa,
                                         const int32_t* __restrict__ lengths,
                                         long long lanes, int N, int s, int g,
                                         void* __restrict__ out, int hits,
                                         int16_t* __restrict__ scratch) {
  extern __shared__ int16_t s_d[];
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const long long T = scratch ? lanes : blockDim.x;
  int16_t* d = scratch ? scratch + lane : s_d + threadIdx.x;
  for (int p = 0; p < N; ++p) d[p * T] = 0;

  const int32_t* t = taxa + lane * (long long)N;
  const int len = lengths[lane];
  scan_seeds(
      N, s, g,
      [&](int p) -> int32_t { return (p < N && p < len) ? t[p] : 0; },
      [&](int p, int v) {
        if (p >= 0 && p < N) d[p * T] = (int16_t)(d[p * T] + v);
      });
  int run = 0;
  if (hits) {
    int32_t* o = (int32_t*)out + lane * (long long)N;
    for (int p = 0; p < N; ++p) {
      run += d[p * T];
      o[p] = (run > 0 && p < len) ? t[p] : 0;
    }
  } else {
    uint8_t* o = (uint8_t*)out + lane * (long long)N;
    for (int p = 0; p < N; ++p) {
      run += d[p * T];
      o[p] = (run > 0 && p < len) ? 1 : 0;
    }
  }
}

template <int NT>
int launch_staged(const void* taxa, const void* lengths, long long lanes,
                  int N, int s, int g, void* out, int hits, int T,
                  cudaStream_t stream) {
  const size_t smem = (size_t)T * (N | 1) * 4 + (size_t)T * N * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seedextend_staged_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec_load = ((uintptr_t)taxa & 15) == 0;
  const long long blocks = (lanes + T - 1) / T;
  seedextend_staged_kernel<NT><<<(unsigned)blocks, T, smem, stream>>>(
      (const int32_t*)taxa, (const int32_t*)lengths, lanes, N, s, g, out,
      hits, vec_load);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out: (lanes, N) int32 hits when `hits`, else bool keep; an allocation
// of its own (16-byte aligned). staged: the tile kernel with T lanes a
// block (a multiple of 16, at most 128), else the direct kernel, with its
// delta rows in `scratch` (lanes * N int16) when that is not null.
extern "C" int seedextend_mask(const void* taxa, const void* lengths,
                               long long lanes, int N, int min_seed_size,
                               int max_gap_size, void* out, int hits,
                               int staged, int T, void* scratch,
                               void* stream) {
  if (lanes <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!staged && scratch) {
    const long long blocks = (lanes + 127) / 128;
    seedextend_direct_kernel<<<(unsigned)blocks, 128, 0, st>>>(
        (const int32_t*)taxa, (const int32_t*)lengths, lanes, N,
        min_seed_size, max_gap_size, out, hits, (int16_t*)scratch);
    return (int)cudaGetLastError();
  }
  if (staged) {
    if (T < 16 || T > MAX_T || T % 16) return (int)cudaErrorInvalidValue;
    if (N == 25)
      return launch_staged<25>(taxa, lengths, lanes, N, min_seed_size,
                               max_gap_size, out, hits, T, st);
    if (N == 45)
      return launch_staged<45>(taxa, lengths, lanes, N, min_seed_size,
                               max_gap_size, out, hits, T, st);
    return launch_staged<0>(taxa, lengths, lanes, N, min_seed_size,
                            max_gap_size, out, hits, T, st);
  }
  // direct: 128 lanes a block while their delta rows fit in 48 KB, fewer
  // (down to one warp) for wide rows, with the opt-in beyond that
  const size_t row = (size_t)N * sizeof(int16_t);
  int threads = 128;
  while (threads > 32 && row * threads > 48 * 1024) threads -= 32;
  const size_t smem = row * threads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seedextend_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (lanes + threads - 1) / threads;
  seedextend_direct_kernel<<<(unsigned)blocks, threads, smem, st>>>(
      (const int32_t*)taxa, (const int32_t*)lengths, lanes, N, min_seed_size,
      max_gap_size, out, hits, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int seedextend_mask_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return seedextend_mask(a.ptr(0), a.ptr(1), a.i(2), (int)a.i(3),
                         (int)a.i(4), (int)a.i(5), a.ptr(6), (int)a.i(7),
                         (int)a.i(8), (int)a.i(9), a.ptr(10), a.ptr(11));
}
