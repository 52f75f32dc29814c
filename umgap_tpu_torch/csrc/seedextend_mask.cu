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
// (PERF.md, section 6).
//
// Rows past the tile (more than 96 windows: reads from 312 bp, every
// rung of the width ladder from 512 bp and the 12,000 bp device width)
// take the row kernel, one warp a lane. What bounded the one-thread-a-
// lane kernel it replaces: 1,536 lanes of 4,000 windows filled 48 warps
// of a 132-SM card, each thread's loads landed a row (16 KB) apart from
// its neighbours', it stepped every window in a dependent chain, and
// past 3,600 windows its int16 delta row lived in global memory and was
// walked twice more. The row kernel:
// - loads its row 32 consecutive windows at a time (one 128-byte line
//   per warp load), four such loads in flight (a sweep of 4, 8 and 16,
//   PERF.md section 6), and only up to the lane's length (the rest
//   reads as 0 without a load);
// - finds the positions where the machine can change state by ballot:
//   the run heads x[p] != x[p - 1], plus, after the leading-gap branch
//   b2 (which keeps last = 0 past a non-zero taxon, so the machine's
//   runs are not the input's), the position after it. The machine
//   steps only there, warp-uniform, adding the skipped `same` steps to
//   same_tid in one go; it stops at the lane's length, past which
//   nothing changes state before the final flush;
// - records each push as an interval [start, stop) in a small per-warp
//   list in shared memory, never a delta row: pushes come in order and
//   never overlap, and the one push that can have start > stop (out of
//   b2's gap) covers nothing a later interval reaches, so the scan's
//   cumsum(deltas) > 0 is the union of the intervals with start < stop;
// - writes every position before the machine's `start` (decided: no
//   later push reaches back past it) with coalesced 32-wide stores when
//   the list fills, when 1,024 decided positions wait, and at the end;
//   the hits epilogue reads a window's taxon again only where it is
//   kept (from L2: the row was just read).
// No block barrier anywhere; a block holds kRowWarps independent lanes.
// ops/seedextend.py seedextend_runs_plain is the same formulation in
// PyTorch.
//
// The scored entries (seedextend_scored, seedextend_rows_scored) replace
// umgap_tpu/ops/seedextend.py:221 seedextend_scored_mask_batch and the
// select after it (the reference's `seedextend -r`,
// src/commands/seedextend.rs:151-164): of a lane's pushes (b1's, then
// the final flush) only the one with the highest score is kept, the last
// of equal ones. A push's score is prefix[stop] - prefix[start] over the
// per-position scores (seed_scores[t] where 0 <= t < size and it is > 0,
// else the penalty; positions past the length and the sentinel score as
// taxon 0), a push with start > stop (out of b2's gap) included. The JAX
// form builds an (N + 1, lanes) candidate tensor and a prefix row; here
// the lane carries three prefix values as it walks: P, the prefix at the
// current step; the prefix at `start`; and the prefix at end - same_tid,
// the stop of the next b1 push (unchanged by a `same` step, moved one
// position on by b2, set to P by b1 and b3). It keeps the best (score,
// start, stop) with >=, and the epilogue writes the taxa of
// [start, stop) inside the length, 0 elsewhere, or with the mask
// epilogue their keep flags (what `seedextend -r` prints is the kept
// windows' taxa, zeros inside the seed included, so it needs the mask).
// The staged tile needs no delta row for it; past it the scored mode has
// a row kernel of its own, K3RS (seedextend_rows_scored_kernel, below:
// G threads a lane, the scores looked up ahead of the walk), which steps
// P over a run as run length x the run's score (the taxon is constant
// between two candidates), lists no intervals and writes the row once,
// at the end. ops/seedextend.py seedextend_scored_runs_plain and
// seedextend_scored_walk_plain are its formulations in PyTorch.

#include <cuda_runtime.h>
#include <limits.h>
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

// A taxon's score in the scored mode: seed_scores[t] where 0 <= t < size
// and it is > 0, else the penalty. s0 is taxon 0's (gaps, the sentinel),
// set by init() in the kernel.
struct SeedScore {
  const int32_t* __restrict__ tab;
  int size, penalty, s0;

  __device__ __forceinline__ void init() {
    const int v = size > 0 ? __ldg(tab) : 0;
    s0 = v > 0 ? v : penalty;
  }

  __device__ __forceinline__ int operator()(int32_t t) const {
    if (t == 0) return s0;
    if ((unsigned)t >= (unsigned)size) return penalty;
    const int v = __ldg(tab + t);
    return v > 0 ? v : penalty;
  }
};

// The state machine of scan_seeds with the running prefixes of the
// scored mode (see the note at the top): returns the best push's
// (start, stop), or (0, 0) when the lane pushes nothing.
template <typename Tx>
__device__ __forceinline__ int2 scan_seeds_scored(int N, int s, int g,
                                                  Tx tx, SeedScore sc) {
  int start = 0, same_tid = 1, same_max = 1;
  int32_t last = tx(0);
  int32_t cur = tx(1);
  int P = sc(last);  // prefix[end]: the scores of positions < end
  int p_start = 0;   // prefix[start]
  int p_run = 0;     // prefix[end - same_tid]
  int best = INT_MIN;
  int2 kept = make_int2(0, 0);
  for (int end = 1; end <= N; ++end) {
    const int32_t nxt = tx(end + 1);  // loaded one step ahead
    const int s_cur = sc(cur);
    const bool same = last == cur;
    const bool b1 = !same && last == 0 && same_tid > g;
    const bool b2 = !same && !b1 && last == 0 && (end - start) == same_tid;
    const bool b3 = !same && !b1 && !b2;
    if (b1 && same_max >= s) {
      const int score = p_run - p_start;
      if (score >= best) {
        best = score;
        kept = make_int2(start, end - same_tid);
      }
    }
    const int n_p_start = b1 ? P : (b2 ? P + s_cur : p_start);
    const int n_p_run =
        same ? p_run : (b2 ? p_run + sc(tx(end - same_tid)) : P);
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
    p_start = n_p_start;
    p_run = n_p_run;
    P += s_cur;
    cur = nxt;
  }
  if (same_max >= s) {  // the final flush; P is prefix[N + 1]
    const int score = (last == 0 ? p_run : P) - p_start;
    if (score >= best)
      kept = make_int2(start, last == 0 ? N + 1 - same_tid : N + 1);
  }
  return kept;
}

// NT: the row width W as a constant, or 0 for the runtime N_rt. SCORED:
// the scored mode (no delta row).
template <int NT, bool SCORED>
__global__ void __launch_bounds__(MAX_T) seedextend_staged_kernel(
    const int32_t* __restrict__ taxa, const int32_t* __restrict__ lengths,
    long long lanes, int N_rt, int s, int g, void* __restrict__ out,
    int hits, int vec_load, SeedScore sc) {
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
  if constexpr (SCORED) {
    sc.init();
    if (tid < nl) {
      const int len = lengths[lane0 + tid];
      int32_t* row = s_tax + tid * S;
      const int2 kept = scan_seeds_scored(
          N, s, g,
          [&](int p) -> int32_t { return (p < N && p < len) ? row[p] : 0; },
          sc);
      for (int p = 0; p < N; ++p) {
        const bool keep = p >= kept.x && p < kept.y && p < len;
        row[p] = hits ? (keep ? row[p] : 0) : (int32_t)keep;
      }
    }
  } else if (tid < nl) {
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

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kRowWarps = 4;      // lanes (warps) a block of the row kernel
constexpr int kRowSub = 4;        // 32-window loads a warp keeps in flight
constexpr int kIvCap = 64;        // kept intervals a warp lists before writing
constexpr int kFlushSpan = 1024;  // decided windows a warp lets wait

// Writes windows [from, upto) of one lane: kept where an interval of
// iv[0, n_iv) (ascending, disjoint) holds the window and it lies inside
// the lane's length; hits (the taxon, read again only where kept) or
// keep flags.
template <bool HITS>
__device__ void write_decided(const int32_t* __restrict__ t, int len,
                              int from, int upto, const int2* iv, int n_iv,
                              void* __restrict__ out, int lane) {
  __syncwarp();  // lane 0 listed the intervals
  int k = 0;
  for (int q0 = from; q0 < upto; q0 += 32 * kRowSub) {
    int32_t v[kRowSub];
#pragma unroll
    for (int u = 0; u < kRowSub; ++u) {
      const int q = q0 + u * 32 + lane;
      bool keep = false;
      if (q < upto) {
        while (k < n_iv && iv[k].y <= q) ++k;
        keep = k < n_iv && iv[k].x <= q && q < len;
      }
      v[u] = HITS ? (keep ? t[q] : 0) : (int32_t)keep;
    }
#pragma unroll
    for (int u = 0; u < kRowSub; ++u) {
      const int q = q0 + u * 32 + lane;
      if (q < upto) {
        if (HITS)
          ((int32_t*)out)[q] = v[u];
        else
          ((uint8_t*)out)[q] = (uint8_t)v[u];
      }
    }
  }
  __syncwarp();  // before lane 0 lists again
}

// One warp a lane: the state machine over the positions where it can
// change state, kept intervals in shared memory, decided windows written
// coalesced (see the note at the top).
template <bool HITS>
__global__ void __launch_bounds__(kRowWarps * 32) seedextend_rows_kernel(
    const int32_t* __restrict__ taxa, const int32_t* __restrict__ lengths,
    long long lanes, int N, int s, int g, void* __restrict__ out) {
  __shared__ int2 s_iv[kRowWarps][kIvCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + warp;
  if (row >= lanes) return;  // the whole warp; no block barrier follows
  const int32_t* t = taxa + row * N;
  void* o = HITS ? (void*)((int32_t*)out + row * N)
                 : (void*)((uint8_t*)out + row * N);
  const int len = min(max(lengths[row], 0), N);
  int2* iv = s_iv[warp];

  // the machine (the same in every lane); e0 is the next step's end
  int start = 0, same_tid = 1, same_max = 1, e0 = 1;
  int32_t last = len > 0 ? t[0] : 0;
  int n_iv = 0, w = 0;  // windows [0, w) are written
  bool extra = false;   // b2's next position opens the next 32 windows
  int32_t carry = last;  // the window before the next 32

  // x is 0 from the lane's length on (the sentinel at N included), so
  // nothing changes state past position len
  for (int c0 = 0; c0 <= len; c0 += 32 * kRowSub) {
    int32_t xv[kRowSub];
#pragma unroll
    for (int u = 0; u < kRowSub; ++u) {
      const int p = c0 + u * 32 + lane;
      xv[u] = p < len ? t[p] : 0;
    }
#pragma unroll
    for (int u = 0; u < kRowSub; ++u) {
      const int cb = c0 + u * 32;
      if (cb > len) continue;  // the whole warp: nothing changes past len
      const int32_t x = xv[u];
      int32_t prev = __shfl_up_sync(FULL, x, 1);
      if (lane == 0) prev = carry;
      const int p = cb + lane;
      unsigned m = __ballot_sync(FULL, p >= 1 && p <= len && x != prev);
      if (extra) {
        m |= 1u;
        extra = false;
      }
      carry = __shfl_sync(FULL, x, 31);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const int32_t cur = __shfl_sync(FULL, x, b);
        const int end = cb + b;
        const int tid = same_tid + (end - e0);  // the `same` steps between
        e0 = end + 1;
        if (last == cur) {
          same_tid = tid + 1;
        } else if (last == 0 && tid > g) {  // b1: a gap longer than g
          const int stop = end - tid;
          if (same_max >= s && start < stop) {
            if (lane == 0) iv[n_iv] = make_int2(start, stop);
            if (++n_iv == kIvCap) {  // windows before `end` are decided
              write_decided<HITS>(t, len, w, end, iv, n_iv, o, lane);
              w = end;
              n_iv = 0;
            }
          }
          start = end;
          last = cur;
          same_tid = 1;
          same_max = 1;
        } else if (last == 0 && end - start == tid) {  // b2: leading gap
          start = end + 1;
          same_tid = tid;
          if (b < 31)
            m |= 1u << (b + 1);
          else
            extra = true;
        } else {  // b3
          if (last != 0) same_max = max(same_max, tid);
          last = cur;
          same_tid = 1;
        }
      }
    }
    if (start - w >= kFlushSpan) {
      write_decided<HITS>(t, len, w, start, iv, n_iv, o, lane);
      w = start;
      n_iv = 0;
    }
  }
  same_tid += N + 1 - e0;  // the `same` steps to the sentinel
  if (same_max >= s) {  // the final flush trims a trailing gap
    const int stop = min(last == 0 ? N + 1 - same_tid : N + 1, N);
    if (start < stop) {
      if (lane == 0) iv[n_iv] = make_int2(start, stop);
      ++n_iv;
    }
  }
  write_decided<HITS>(t, len, w, N, iv, n_iv, o, lane);
}

// ---- K3RS: the scored row kernel ------------------------------------
// Rows past the staged tile in the scored mode (`seedextend -r`, the
// ranked presets on reads past 312 bp). What held its first form (the
// row kernel's scored instance, one warp a lane) back: at every
// candidate position of the warp-uniform walk it loaded the candidate's
// score (seed_scores[cur], L1/L2), a dependent load on the walk's
// critical path; all 32 threads ran that one scalar chain; a row of 132
// windows (420 bp) took two 128-window passes, the second for 4 windows;
// and it spilled 40 B of registers.
//
// Here G threads walk a lane (G = 16 or 32: 2 lanes a warp or 1; the
// wrapper picks G by the row width, ops/seedextend.py
// scored_lane_threads). A group loads a pass of kScoredPass windows of
// its lane (rounded up to a whole number of G; a 420 bp row is one
// pass), G consecutive windows a load, and each thread looks up its
// windows' scores right after: independent loads, all in flight
// together. The candidates of G windows come from one ballot (run heads,
// plus the position after b2's); the walk steps the machine at each, all
// groups of the warp in step (a group with none left idles), and reads
// the candidate's taxon and score from its thread by shuffle: no load
// is left in the walk. The prefix at a candidate needs no scan: between
// two candidates the taxon is constant, so the prefix advances by run
// length x the run's score. b2's moved stop adds the score of taxon 0:
// b2 needs a lane that opens with 1 to g zeros and fires at the first
// non-zero window, whose run of `last` (0) starts at end - tid = 0, so
// the window at the old stop is a zero (seedextend.py
// seedextend_scored_walk_plain is this formulation in PyTorch). The
// epilogue writes the lane's row once, G windows a store: a row that fit
// one pass from the registers, a wider one with the taxa of the kept
// push read again only inside it.
//
// Swept on the H100 (chip_smoke.py redesign_sweep, sweep_constant;
// PERF.md section 6): the staged tile past 96 windows took 0.043-0.229
// ms at 102-333 windows against K3RS's 0.042-0.062; 16 threads a lane
// beat 32 up to 162 windows, tied at 333 and lost at 4,000 (0.20-0.21
// against 0.15); one thread a lane over 32-window chunks of a shared
// tile took 0.063-0.065 at 132; passes of 144 windows took 0.0515 ms at
// 132 against 0.055 for 128 (two passes) and 0.058 for 256 (more
// registers, fewer warps an SM). What bounds it now is instruction
// issue: every candidate step runs on G threads, and each G windows cost
// a ballot and shuffles.
constexpr int kScoredPass = 144;  // windows a pass, rounded up to G

template <bool HITS, int G>
__global__ void __launch_bounds__(kRowWarps * 32)
    seedextend_rows_scored_kernel(const int32_t* __restrict__ taxa,
                                  const int32_t* __restrict__ lengths,
                                  long long lanes, int N, int s, int g,
                                  void* __restrict__ out, SeedScore sc) {
  constexpr int LPW = 32 / G;   // lanes a warp
  constexpr int SUB = (kScoredPass + G - 1) / G;  // G-window loads a pass
  constexpr int PASS = SUB * G;
  constexpr unsigned GMASK = G == 32 ? FULL : (1u << G) - 1;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int gl = wl & (G - 1), grp = wl / G;
  const long long row0 = ((long long)blockIdx.x * kRowWarps + warp) * LPW;
  if (row0 >= lanes) return;  // the whole warp; no block barrier follows
  const long long row = row0 + grp;
  const bool live = row < lanes;
  const int32_t* t = taxa + (live ? row : row0) * N;
  // a group past the last lane walks nothing and writes nothing
  const int len = live ? min(max(lengths[row], 0), N) : -1;
  sc.init();

  // the machine (the same in each thread of a group); e0 is the next
  // step's end. The prefixes (see the note at the top): at e0, at start
  // and at e0 - same_tid; the score of the run from e0 on; the best push
  int start = 0, same_tid = 1, same_max = 1, e0 = 1;
  int32_t last = len > 0 ? t[0] : 0;
  bool extra = false;    // b2's next position opens the next G windows
  int32_t carry = last;  // the window before the next G
  int p_e0 = sc(last), s_run = p_e0, p_start = 0, p_run = 0, best = INT_MIN;
  int2 kept = make_int2(0, 0);

  // x is 0 from the lane's length on (the sentinel at N included), so
  // nothing changes state past position len
  int32_t xv[SUB];  // the pass's windows; a row shorter than PASS: all
  for (int c0 = 0; __any_sync(FULL, c0 <= len); c0 += PASS) {
    int sv[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int p = c0 + u * G + gl;
      xv[u] = p < len ? t[p] : 0;
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u) sv[u] = sc(xv[u]);
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int cb = c0 + u * G;
      if (!__any_sync(FULL, cb <= len)) break;  // every group is done
      const int32_t x = xv[u];
      int32_t prev = __shfl_up_sync(FULL, x, 1, G);
      if (gl == 0) prev = carry;
      const int p = cb + gl;
      unsigned m =
          (__ballot_sync(FULL, p >= 1 && p <= len && x != prev) >> (grp * G)) &
          GMASK;
      if (extra) {
        m |= 1u;
        extra = false;
      }
      carry = __shfl_sync(FULL, x, G - 1, G);
      while (__any_sync(FULL, m != 0)) {
        const int b = __ffs(m) - 1;
        const int32_t cur = __shfl_sync(FULL, x, b, G);
        const int s_cur = __shfl_sync(FULL, sv[u], b, G);
        if (m == 0) continue;  // this group has no candidate left
        m &= m - 1;
        const int end = cb + b;
        const int tid = same_tid + (end - e0);  // the `same` steps between
        const int p_end = p_e0 + (end - e0) * s_run;  // the taxon is constant
        p_e0 = p_end + s_cur;
        s_run = s_cur;
        e0 = end + 1;
        if (last == cur) {
          same_tid = tid + 1;
        } else if (last == 0 && tid > g) {  // b1: a gap longer than g
          if (same_max >= s && p_run - p_start >= best) {
            best = p_run - p_start;
            kept = make_int2(start, end - tid);
          }
          p_start = p_run = p_end;
          start = end;
          last = cur;
          same_tid = 1;
          same_max = 1;
        } else if (last == 0 && end - start == tid) {  // b2: leading gap
          p_run += sc.s0;  // the run's stop moves on by one, over a zero
          p_start = p_end + s_cur;
          start = end + 1;
          same_tid = tid;
          if (b < G - 1)
            m |= 1u << (b + 1);
          else
            extra = true;
        } else {  // b3
          p_run = p_end;
          if (last != 0) same_max = max(same_max, tid);
          last = cur;
          same_tid = 1;
        }
      }
    }
  }
  if (!live) return;
  const int tail = N + 1 - e0;  // the `same` steps to the sentinel
  same_tid += tail;
  // the final flush; prefix[N + 1] = p_e0 + tail * s_run
  if (same_max >= s &&
      (last == 0 ? p_run : p_e0 + tail * s_run) - p_start >= best)
    kept = make_int2(start, last == 0 ? N + 1 - same_tid : N + 1);

  // the row, once: the kept push's windows inside the length, from the
  // registers where the row fit one pass, else read again where kept
  const int a = kept.x, z = min(kept.y, len);
  for (int q0 = 0; q0 < N; q0 += PASS) {
    int32_t v[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int q = q0 + u * G + gl;
      const bool keep = q >= a && q < z;
      v[u] = HITS ? (keep ? (N < PASS ? xv[u] : t[q]) : 0)
                  : (int32_t)keep;
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int q = q0 + u * G + gl;
      if (q < N) {
        if (HITS)
          ((int32_t*)out)[row * N + q] = v[u];
        else
          ((uint8_t*)out)[row * N + q] = (uint8_t)v[u];
      }
    }
  }
}

template <int NT, bool SCORED>
int launch_staged(const void* taxa, const void* lengths, long long lanes,
                  int N, int s, int g, void* out, int hits, int T,
                  SeedScore sc, cudaStream_t stream) {
  const size_t smem =
      (size_t)T * (N | 1) * 4 + (SCORED ? 0 : (size_t)T * N * 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seedextend_staged_kernel<NT, SCORED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec_load = ((uintptr_t)taxa & 15) == 0;
  const long long blocks = (lanes + T - 1) / T;
  seedextend_staged_kernel<NT, SCORED><<<(unsigned)blocks, T, smem,
                                         stream>>>(
      (const int32_t*)taxa, (const int32_t*)lengths, lanes, N, s, g, out,
      hits, vec_load, sc);
  return (int)cudaGetLastError();
}

template <bool SCORED>
int launch_staged_n(const void* taxa, const void* lengths, long long lanes,
                    int N, int s, int g, void* out, int hits, int T,
                    SeedScore sc, cudaStream_t stream) {
  if (T < 16 || T > MAX_T || T % 16) return (int)cudaErrorInvalidValue;
  if (N == 25)
    return launch_staged<25, SCORED>(taxa, lengths, lanes, N, s, g, out,
                                     hits, T, sc, stream);
  if (N == 45)
    return launch_staged<45, SCORED>(taxa, lengths, lanes, N, s, g, out,
                                     hits, T, sc, stream);
  return launch_staged<0, SCORED>(taxa, lengths, lanes, N, s, g, out, hits,
                                  T, sc, stream);
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out: (lanes, N) int32 hits when `hits`, else bool keep; an allocation
// of its own (16-byte aligned). The staged tile, T lanes a block (a
// multiple of 16, at most 128), for rows of up to 96 windows.
extern "C" int seedextend_mask(const void* taxa, const void* lengths,
                               long long lanes, int N, int min_seed_size,
                               int max_gap_size, void* out, int hits, int T,
                               void* stream) {
  if (lanes <= 0 || N <= 0) return 0;
  return launch_staged_n<false>(taxa, lengths, lanes, N, min_seed_size,
                                max_gap_size, out, hits, T, SeedScore{},
                                (cudaStream_t)stream);
}

extern "C" int seedextend_mask_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return seedextend_mask(a.ptr(0), a.ptr(1), a.i(2), (int)a.i(3),
                         (int)a.i(4), (int)a.i(5), a.ptr(6), (int)a.i(7),
                         (int)a.i(8), a.ptr(9));
}

// The row kernel, one warp a lane, at any N (the wrapper takes it past
// the tile's 96 windows).
extern "C" int seedextend_rows(const void* taxa, const void* lengths,
                               long long lanes, int N, int min_seed_size,
                               int max_gap_size, void* out, int hits,
                               void* stream) {
  if (lanes <= 0 || N <= 0) return 0;
  const long long blocks = (lanes + kRowWarps - 1) / kRowWarps;
  if (hits)
    seedextend_rows_kernel<true><<<(unsigned)blocks, kRowWarps * 32, 0,
                                   (cudaStream_t)stream>>>(
        (const int32_t*)taxa, (const int32_t*)lengths, lanes, N,
        min_seed_size, max_gap_size, out);
  else
    seedextend_rows_kernel<false><<<(unsigned)blocks, kRowWarps * 32, 0,
                                    (cudaStream_t)stream>>>(
        (const int32_t*)taxa, (const int32_t*)lengths, lanes, N,
        min_seed_size, max_gap_size, out);
  return (int)cudaGetLastError();
}

extern "C" int seedextend_rows_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return seedextend_rows(a.ptr(0), a.ptr(1), a.i(2), (int)a.i(3),
                         (int)a.i(4), (int)a.i(5), a.ptr(6), (int)a.i(7),
                         a.ptr(8));
}

// The scored entries (see the note at the top): out (lanes, N) int32, the
// taxa of each lane's best push inside its length, 0 elsewhere, when
// `hits`, else bool keep; seed_scores (size,) int32 on the card. The
// staged tile, T lanes a block, for rows of up to 96 windows.
extern "C" int seedextend_scored(const void* taxa, const void* lengths,
                                 long long lanes, int N, int min_seed_size,
                                 int max_gap_size, const void* seed_scores,
                                 int size, int penalty, void* out, int hits,
                                 int T, void* stream) {
  if (lanes <= 0 || N <= 0) return 0;
  return launch_staged_n<true>(taxa, lengths, lanes, N, min_seed_size,
                               max_gap_size, out, hits, T,
                               SeedScore{(const int32_t*)seed_scores, size,
                                         penalty, 0},
                               (cudaStream_t)stream);
}

extern "C" int seedextend_scored_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return seedextend_scored(a.ptr(0), a.ptr(1), a.i(2), (int)a.i(3),
                           (int)a.i(4), (int)a.i(5), a.ptr(6), (int)a.i(7),
                           (int)a.i(8), a.ptr(9), (int)a.i(10),
                           (int)a.i(11), a.ptr(12));
}

// The scored row kernel at any N; `hits` as above; lane_threads (16 or
// 32) threads walk a lane.
extern "C" int seedextend_rows_scored(const void* taxa, const void* lengths,
                                      long long lanes, int N,
                                      int min_seed_size, int max_gap_size,
                                      const void* seed_scores, int size,
                                      int penalty, void* out, int hits,
                                      int lane_threads, void* stream) {
  if (lanes <= 0 || N <= 0) return 0;
  if (lane_threads != 16 && lane_threads != 32)
    return (int)cudaErrorInvalidValue;
  const int per_block = kRowWarps * (32 / lane_threads);
  const unsigned blocks = (unsigned)((lanes + per_block - 1) / per_block);
  const cudaStream_t st = (cudaStream_t)stream;
  const SeedScore sc{(const int32_t*)seed_scores, size, penalty, 0};
  const int32_t* tx = (const int32_t*)taxa;
  const int32_t* ln = (const int32_t*)lengths;
  const int s = min_seed_size, g = max_gap_size;
  if (lane_threads == 16) {
    if (hits)
      seedextend_rows_scored_kernel<true, 16><<<blocks, kRowWarps * 32, 0,
                                                st>>>(tx, ln, lanes, N, s, g,
                                                      out, sc);
    else
      seedextend_rows_scored_kernel<false, 16><<<blocks, kRowWarps * 32, 0,
                                                 st>>>(tx, ln, lanes, N, s,
                                                       g, out, sc);
  } else {
    if (hits)
      seedextend_rows_scored_kernel<true, 32><<<blocks, kRowWarps * 32, 0,
                                                st>>>(tx, ln, lanes, N, s, g,
                                                      out, sc);
    else
      seedextend_rows_scored_kernel<false, 32><<<blocks, kRowWarps * 32, 0,
                                                 st>>>(tx, ln, lanes, N, s,
                                                       g, out, sc);
  }
  return (int)cudaGetLastError();
}

extern "C" int seedextend_rows_scored_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return seedextend_rows_scored(a.ptr(0), a.ptr(1), a.i(2), (int)a.i(3),
                                (int)a.i(4), (int)a.i(5), a.ptr(6),
                                (int)a.i(7), (int)a.i(8), a.ptr(9),
                                (int)a.i(10), (int)a.i(11), a.ptr(12));
}
