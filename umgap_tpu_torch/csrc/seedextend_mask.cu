// K3 seedextend_mask: per-lane seed-and-extend keep mask.
//
// Replaces umgap_tpu/ops/seedextend.py:118 seedextend_mask_batch, whose
// TPU form is a lax.scan (_scan_seeds, :173) advancing every lane one
// position per step and turning the recorded seed pushes into +1/-1
// deltas and a cumulative sum. Here one thread owns one (read, end,
// frame) lane and runs the reference's state machine
// (src/commands/seedextend.rs:96-178, transliterated at
// seedextend.py:30-70) over its W window taxa with the state in
// registers, keeping the realized quirks: the leading-gap branch (b2)
// that moves the seed start past the current position, and the trim of
// a trailing gap at the final flush. Pushes add +1 at their start and -1
// at their stop (positions outside [0, W) are dropped, as in the scan's
// one-hot deltas) into an int16 delta row in shared memory; a second
// pass over the row takes the running sum and writes keep = sum > 0
// inside the lane's length.
//
// Bound on the H100: bytes. Each lane reads W int32 taxa and its length
// and writes W bytes; the state machine is a handful of integer selects
// per position. Threads own rows, so global loads are strided by W * 4
// bytes within a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

__global__ void seedextend_kernel(const int32_t* __restrict__ taxa,
                                  const int32_t* __restrict__ lengths,
                                  long long lanes, int N, int s, int g,
                                  uint8_t* __restrict__ keep) {
  extern __shared__ int16_t s_delta[];  // [N][blockDim.x]
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int T = blockDim.x;
  int16_t* d = s_delta + threadIdx.x;
  for (int p = 0; p < N; ++p) d[p * T] = 0;

  const int32_t* t = taxa + lane * (long long)N;
  const int len = lengths[lane];
  auto tx = [&](int p) -> int32_t { return (p < N && p < len) ? t[p] : 0; };
  auto add = [&](int p, int v) {
    if (p >= 0 && p < N) d[p * T] = (int16_t)(d[p * T] + v);
  };

  int start = 0, same_tid = 1, same_max = 1;
  int32_t last = tx(0);
  for (int end = 1; end <= N; ++end) {
    const int32_t cur = tx(end);
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
  }
  if (same_max >= s) {
    const int f_end = N + 1;
    add(start, 1);
    add(last == 0 ? f_end - same_tid : f_end, -1);
  }

  uint8_t* k = keep + lane * (long long)N;
  int run = 0;
  for (int p = 0; p < N; ++p) {
    run += d[p * T];
    k[p] = (run > 0 && p < len) ? 1 : 0;
  }
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Block size: 128 lanes while their delta rows fit in 48 KB of shared
// memory, fewer (down to one warp) for wide rows, with the opt-in to
// more shared memory beyond that.
extern "C" int seedextend_mask(const void* taxa, const void* lengths,
                               long long lanes, int N, int min_seed_size,
                               int max_gap_size, void* keep, void* stream) {
  if (lanes <= 0 || N <= 0) return 0;
  const size_t row = (size_t)N * sizeof(int16_t);
  int threads = 128;
  while (threads > 32 && row * threads > 48 * 1024) threads -= 32;
  const size_t smem = row * threads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        seedextend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (lanes + threads - 1) / threads;
  seedextend_kernel<<<(unsigned)blocks, threads, smem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)taxa, (const int32_t*)lengths, lanes, N, min_seed_size,
      max_gap_size, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

extern "C" int seedextend_mask_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return seedextend_mask(a.ptr(0), a.ptr(1), a.i(2), (int)a.i(3), (int)a.i(4),
                         (int)a.i(5), a.ptr(6), a.ptr(7));
}
