// K6 tree_aggregate: the per-read tree aggregators over a read group's
// deduplicated hit list, one kernel templated on the strategy:
//   hybrid (tree::mix, factor f), lca* (tree::lca) and mrtl (rmq::rtl).
// A slot's lineage is the row of dtax.geom, (size, 1 + D) = [depth |
// ancestors], at clamp(id, 0, size - 1), read by the kernel itself; the
// ancestry test is computed from the rows.
//
// Replaces umgap_tpu/agg/device.py:219 tree_lca_batch, :243 rtl_batch and
// :253 tree_mix_batch (with _argmax_tiebreak) over :170 hit_geometry,
// whose row gather and ancestry compare the JAX package runs as XLA ops
// over the whole (B, K, D) and (B, K, K) tensors. The port builds
// neither: the kernel reads the rows of the valid slots.
//
// Semantics kept exactly (the plain versions in agg/device.py):
//   hybrid: from the root, descend over D - 1 depths; at depth d the
//     slots below x are the valid ones with lin[d] == x and a depth-(d+1)
//     ancestor (the branch); a branch's sum is the counts of the valid
//     slots sharing it; with several branches the heaviest (ties: smallest
//     branch id) is taken unless (maxsum / a_base) < factor in float32,
//     a division as written there, and a_base becomes maxsum; a single
//     branch is descended with no factor test; no slot below stops.
//   lca*: if some valid slot j has every valid slot as an ancestor-or-
//     self (a dominated chain), the deepest such j (first on ties);
//     else the ancestor at the deepest depth where all valid lineages
//     agree with the first valid one's (slot 0's when none is valid;
//     depth 0 when no depth agrees).
//   mrtl: score of j = counts of the valid slots that are ancestors-or-
//     self of j; maximum score, then maximum depth, then minimum id; no
//     valid slot gives I32_MAX.
//   Slot i is an ancestor-or-self of slot j when lin_j[dep_i] == id_i,
//   dep_i = max(row_i[0], 0) (K5's ancestry epilogue, ops/gather.py).
// Counts are summed in float32. The path's integer counts (below 2^24)
// sum exactly in any order. Weighted counts (taxa2agg -s: 0.1, 0.3) round
// by the order of their adds, so the launch takes `ordered` for them and
// runs instances (ORD) that add as umgap_tpu's host aggregators
// (umgap_tpu/agg/host.py) add, over a group of distinct valid ids whose
// slots K4's weighted instances hand over in first-seen order:
//   hybrid (TreeMix): a_base is numpy's float32 sum of the slots' counts
//     in slot order, a branch's sum numpy's sum of its slots below x in
//     slot order (np_pairwise: one at a time below 8 terms, 8
//     accumulators up to 128, halves split at a multiple of 8 past it);
//     one thread walks the group (hybrid_ordered), on every path;
//   mrtl (RmqRTL, a numpy reduce over axis 0): score(j) adds the
//     ancestors-or-self of j one at a time in slot order, from 0.0f (the
//     thread and warp paths as the unordered ones; the block path tests
//     every slot against each j, score_slots, instead of its searches).
// The unordered instances are the ones the main path has always run.
//
// Snap, fused into the store (with the pipeline's snap table, as taxa2agg
// ends, umgap_tpu/pipeline/fused.py:122-124 over umgap_tpu/agg/device.py:
// 308 snap_batch): every path writes a group's result through one device
// function, Store::put, which with a table writes 1 for a group with no
// valid slot, else snap[x] when 0 <= x < size and snap[x] != NONE, else
// 0. The table (80 KB for the bench's 20,001 taxa) stays in L2; a group
// adds one 4-byte load at its store, and the pipeline no longer runs
// K5's 1-D take and the eight elementwise launches around it (the
// clamp, three compares, two ands, two selects) and the any-valid
// reduction. Without a table the result is written as it is.
//
// What bounds it. Per group the work needs the valid mask (K bytes), the
// id and count of each valid slot and one lineage row per distinct valid
// id, and writes 4 bytes. At the bench's 1-3 valid slots of K = 64 that
// is about 100 bytes a group: 0.5-0.8 us for 16,384 groups at 3.35 TB/s,
// below what one launch of that many groups takes, so the kernel is held
// to a measured floor (the same launch on groups with no valid slot)
// beside its bound. Past K = 64 (the wide program's groups, K = 408 to
// 16,392 and more, thousands of valid slots) the same bytes bound it:
// the mask and the rows of the valid ids, a few MB for a batch of 8 to 64
// groups; the walk's operations, O(n D log n) a group below, are far
// under the card's rate. What a group's walk costs in time is the chain
// of dependent steps in one block (barriers, searches), so groups are
// spread over the whole card, a block each.
//
// Design, K <= 64 (the main path's 9-mer and tryptic steps, and the
// tryptic wide program). A block owns 32 consecutive groups. Its first
// warp walks them a thread a group (the thread path): the thread scans
// its group's valid mask with 16-byte loads, keeps the slots in a
// per-thread list in shared memory ([entry][lane], so lanes at the same
// entry hit distinct banks), loads their ids and counts once, and walks
// its group alone, reading lineage entries of the listed rows only
// (L1/L2; at most a few hundred bytes a group). All blocks of a
// 16,384-group batch are resident at once, so a batch takes as long as
// its slowest walk: hybrid's walk of up to kSmall = 4 slots (the bench's
// groups) keeps the rows' pointers and two lineage columns in registers
// and loads the next column a step ahead (hybrid_small), which took the
// bench batch from 0.023 to 0.008 ms, where reading the list and loading
// a column per slot and step had paid a load's latency at each of 25
// steps. A group with more than kThreadCap = 16 valid slots is left to
// the warp path: after a block barrier the block's kBlockWarps warps deal
// its such groups out in turn; a warp compacts a group's valid slots with
// ballots into a shared list (ids, counts, depths) and runs the same
// algorithms with lanes over the list and warp reductions, the ancestry
// tests eight independent loads at a time; after each descent hybrid
// keeps only the slots under the new node. So a group's work follows its
// valid slots, not K, and a batch of full groups keeps four groups a warp
// (the other warps of a block wait at the barrier while the first walks).
// The sizes come from sweeps on an H100 (chip_smoke.py sweep_constant,
// PERF.md): a thread path limit of 4 or 16 gave the bench batch the same
// time within 5% (0 or 2, which send its groups to the warp path, 1.8-5x
// as long); of 4, 8 and 16 warps a block, 4 took 1.2-1.5x as long as 8 on
// batches of 17-64 and of 64 valid hits a group (but for mrtl's full
// groups, 0.85x), 16 the same as 8 there but 1.8x as long on the bench
// batch. tree_kernel and its launch keep the warp lists' global scratch
// (wider K took it before the block path), never used at K <= 64: taking
// it out changed how these kernels compile (56, 56 and 64 registers to
// 47, 48 and 53) and mrtl on full groups took 15-20% longer (H100 80GB
// HBM3 at 700 W), so the main path's kernels stay as they were.
//
// Design, K > 64: the block path (tree_block_kernel), a block of
// kBlockThreads a group, the grid striding over the batch. The block
// compacts the group's valid slots in slot order (a thread a 16-byte
// piece of the mask, a block scan of the pieces' counts) into a list of
// 12 bytes a slot: id, count and a third word. The list lives in shared
// memory up to K = 17,920 (the wide program of 4,096 bp reads, K =
// 16,392, takes 213 KB with the 16 KB auxiliary area below), else in a
// global scratch of one list a block that the caller allocates, the grid
// then cut to the scratch's blocks; block barriers order it as they do
// shared memory. A group of at most kThreadCap valid slots takes the
// thread path's walk on thread 0. Otherwise:
//   lca* and mrtl sort the list's ids in shared memory (a bitonic network
//   whose comparators all put the smaller key first, so a list of any
//   length sorts as if padded with +inf; skipped when the ids are already
//   ascending and distinct, as K4 hands them over), fold equal ids into
//   one entry with their summed counts (mrtl) or multiplicity (lca*) and
//   clamped depth, and score each distinct id j: for each depth d, a
//   search of lin_j[d] among the sorted ids (branch-free, four depths at
//   a time so that their shared-memory loads overlap), counted when found
//   with clamped depth d. That is the ancestry test lin_j[dep_i] == id_i
//   of every slot i, each distinct id once: O(n D log n) a group where the
//   warp path tested n^2 pairs. mrtl takes the block's best (score,
//   depth, -id); lca* the deepest id whose multiplicity sum is n (two
//   such ids of one depth are equal, so the plain version's first slot is
//   its id; with more distinct ids than depths none is, and the scores
//   are skipped), else the deepest depth where every distinct lineage
//   agrees with the first valid slot's (64 depths a block reduction).
//   hybrid keeps the descent (slot order does not matter to it); each
//   depth's pass keeps in place only the slots under x, and the slots
//   below x write their branch to the third word. With several branches
//   their sums come from a shared hash table keyed by branch id (linear
//   probing): a warp first sums its slots of each branch
//   (__match_any_sync), so one atomic add goes in a branch and warp,
//   where thousands of slots of a few branches near the root had queued
//   on the same words (0.72 ms at K = 16,392 before, 0.21 after, on an
//   H100 80GB HBM3 at 700 W). The
//   table takes at most kHashFill new branches a pass (a branch that
//   missed a full pass is looked up once the pass's table is final, and
//   waits for the next pass if absent), so a depth costs the subtree's
//   slots, not their square. The sums are over the slots below x, where
//   the plain version sums every valid slot with the branch: equal on a
//   taxonomy whose rows are lineages (a slot with ancestor y at depth
//   d + 1 has y's ancestor at depth d), as every Taxonomy's are.
// The block scans that place compacted entries take one barrier each
// (two alternating buffers of warp totals). Sizes from the sweep of
// kBlockThreads on an H100 80GB HBM3 at 700 W (chip_smoke.py
// sweep_constant, mode "wide", PERF.md): 512 threads; 1,024 take mrtl at K = 16,392 from 0.40 to 0.30
// ms but hybrid at K = 408-648 from 0.053 to 0.10-0.11 (the wide program
// of 100-160 bp reads), and 256 take hybrid and mrtl at K = 16,392 to
// 0.25 and 0.51.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int32_t I32_MAX = 0x7FFFFFFF;
constexpr int32_t NONE = -1;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kHybrid = 0, kLca = 1, kMrtl = 2;
constexpr int kThreadCap = 16;  // most valid slots the thread path walks
constexpr int kSmall = 4;       // hybrid's walk in registers up to here
constexpr int kBlockWarps = 8;  // warps sharing a block's larger groups
constexpr int kAncBatch = 8;    // ancestry tests issued together
// the block's dynamic shared memory, below the 227 KB a block may hold
// with its static word
constexpr size_t kSmemMax = 226 * 1024;
// the thread path's lists: slot, id, count, depth; kThreadCap x 32 lanes
constexpr size_t kThreadBytes = (size_t)kThreadCap * 32 * 16;
// ---- the block path (K > kWideK) ---- //
constexpr int kWideK = 64;          // widest K of the thread and warp paths
constexpr int kBlockThreads = 512;  // threads of a block, a group a block
constexpr int kBlockGrid = 528;     // most blocks a launch (4 an SM)
constexpr int kHashSlots = 2048;    // hybrid's branch table, a power of 2
constexpr int kHashFill = 1024;     // new branches a pass of it may take
// the auxiliary area before the list: hybrid's table (keys, sums) or the
// thread walk's lists (ids, counts, depths) on thread 0
constexpr size_t kAuxBytes = (size_t)kHashSlots * 8;
constexpr int kWarps = kBlockThreads / 32;
static_assert(kBlockThreads % 32 == 0 && kBlockThreads <= 1024, "block");
// a probe always meets an empty slot: at most kHashFill - 1 + kBlockThreads
// branches enter a table (each thread checks the fill before its insert)
static_assert(kHashFill + kBlockThreads <= kHashSlots, "hash table");
static_assert((size_t)kThreadCap * 32 * 12 <= kAuxBytes, "thread walk");

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The taxonomy rows, dtax.geom: size rows of W = 1 + D int32.
struct Rows {
  const int32_t* geom;
  int size, W, D;
  // the ancestors of id u, at hit_geometry's clamped id (an invalid
  // slot's row is row 0: lin(0))
  __device__ __forceinline__ const int32_t* lin(int u) const {
    return geom + (long long)min(max(u, 0), size - 1) * W + 1;
  }
  __device__ __forceinline__ int depth(int u) const {
    return max(lin(u)[-1], 0);
  }
  // slot i (id ui, depth di) an ancestor-or-self of the slot whose
  // ancestors are lj
  __device__ __forceinline__ bool anc(int ui, int di,
                                      const int32_t* lj) const {
    return lj[min(di, D - 1)] == ui;
  }
};

// Where a group's result goes: out[b], through the snap table when there
// is one (see the note at the top). n: the group's valid slots.
struct Store {
  int32_t* out;
  const int32_t* snap;  // null: the result as it is
  int snap_size;
  __device__ __forceinline__ void put(long long b, int n, int x) const {
    if (snap != nullptr) {
      const int32_t s = x >= 0 && x < snap_size ? snap[x] : NONE;
      x = n == 0 ? 1 : s != NONE ? s : 0;
    }
    out[b] = x;
  }
};

// Shared memory of one warp on the warp path: slot, id, count, depth and
// lineage column, K entries each.
__host__ __device__ inline size_t list_bytes(int K) {
  return ((size_t)K * 20 + 15) & ~(size_t)15;
}

// The valid slots of one group's mask in slot order: the first `cap`
// go to list[0], list[stride], ...; stops once more than `cap` are seen.
// Returns the count seen (cap + 1 at most).
__device__ __forceinline__ int scan_mask(const uint8_t* row, int K, int cap,
                                         int* list, int stride) {
  int n = 0;
  int k = 0;
  const int head = (int)((16 - ((uintptr_t)row & 15)) & 15);
  for (; k < K && k < head; ++k) {
    if (row[k]) {
      if (n < cap) list[n * stride] = k;
      if (++n > cap) return n;
    }
  }
  for (; k + 16 <= K; k += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + k);
    const unsigned ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned x = ws[q];
      while (x) {
        const int bit = __ffs(x) - 1;
        if (n < cap) list[n * stride] = k + 4 * q + (bit >> 3);
        if (++n > cap) return n;
        x &= ~(0xFFu << (bit & ~7));
      }
    }
  }
  for (; k < K; ++k) {
    if (row[k]) {
      if (n < cap) list[n * stride] = k;
      if (++n > cap) return n;
    }
  }
  return n;
}

// ---- hybrid on the thread path for a group of n <= kSmall slots: the
// rows' pointers, counts and two lineage columns live in registers
// (every loop over the slots unrolled), and the next column's loads are
// issued a step ahead, so a depth step costs ALU work, not a load's
// latency per slot. The same steps as thread_group's hybrid.
__device__ int hybrid_small(const Rows& src, int n, const int* tu,
                            const float* tc, int root, float factor) {
  const int D = src.D;
  const int32_t* p[kSmall];
  float c[kSmall];
  int32_t cur[kSmall], nxt[kSmall];
  float a_base = 0.0f;
#pragma unroll
  for (int e = 0; e < kSmall; ++e) {
    p[e] = e < n ? src.lin(tu[e * 32]) : nullptr;
    c[e] = e < n ? tc[e * 32] : 0.0f;
    a_base += c[e];  // slot order; the padding adds 0
    cur[e] = e < n ? p[e][0] : NONE;
    nxt[e] = e < n && D > 1 ? p[e][1] : NONE;
  }
  int x = root;
  for (int d = 0; d + 1 < D; ++d) {
    int32_t ahead[kSmall];
#pragma unroll
    for (int e = 0; e < kSmall; ++e)
      ahead[e] = e < n && d + 2 < D ? p[e][d + 2] : NONE;
    bool below[kSmall];
    bool any = false;
    int bmin = I32_MAX, bmax = -1;  // as the plain version's
#pragma unroll
    for (int e = 0; e < kSmall; ++e) {
      below[e] = nxt[e] != NONE && cur[e] == x;
      if (below[e]) {
        any = true;
        bmin = min(bmin, nxt[e]);
        bmax = max(bmax, nxt[e]);
      }
    }
    if (!any) break;  // nothing below x: stop
    if (bmin == bmax) {  // one branch: descend, no factor test
      x = bmin;
    } else {
      float mx = -INFINITY;
      int best = I32_MAX;
#pragma unroll
      for (int e = 0; e < kSmall; ++e) {
        if (!below[e]) continue;
        float s = 0.0f;
#pragma unroll
        for (int f = 0; f < kSmall; ++f)
          if (f < n && nxt[f] == nxt[e]) s += c[f];
        if (s > mx || (s == mx && nxt[e] < best)) {
          mx = s;
          best = nxt[e];
        }
      }
      if ((mx / a_base) < factor) break;  // the heaviest share is too low
      x = best;
      a_base = mx;
    }
#pragma unroll
    for (int e = 0; e < kSmall; ++e) {
      cur[e] = nxt[e];
      nxt[e] = ahead[e];
    }
  }
  return x;
}

// ---- the ordered instances' sums (see the note at the top) ---------- //

// The entries of a list in order, at a stride: every entry, or those
// whose column `col` holds `want`.
struct ListCursor {
  const int* col;
  const float* c;
  int s, want, p;
  bool every;
  __device__ float operator()() {
    if (!every)
      while (col[p * s] != want) ++p;
    return c[(p++) * s];
  }
};

// numpy's pairwise float32 sum of the next n entries (umath's
// pairwise_sum); the caller adds it to 0.0f, the reduction's identity.
__device__ float np_pairwise(ListCursor& next, int n) {
  if (n < 8) {
    float r = 0.0f;
    for (int i = 0; i < n; ++i) r += next();
    return r;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; ++j) r[j] = next();
    const int m = n - n % 8;
    for (int i = 8; i < m; i += 8)
      for (int j = 0; j < 8; ++j) r[j] += next();
    float res = ((r[0] + r[1]) + (r[2] + r[3])) +
                ((r[4] + r[5]) + (r[6] + r[7]));
    for (int i = m; i < n; ++i) res += next();
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  const float a = np_pairwise(next, n2);  // the left half first
  return a + np_pairwise(next, n - n2);
}

// hybrid as TreeMix adds, one thread over a list of n slots in first-seen
// order (ids u, counts c, a scratch column col; stride s): the branches
// below x are taken in list order, each summed over its slots below x in
// list order, the heaviest kept (ties: the smallest branch id); after a
// descent the list keeps, in place and in order, the slots under x.
__device__ int hybrid_ordered(const Rows& src, int n, int* u, float* c,
                              int* col, int s, int root, float factor) {
  ListCursor every{col, c, s, 0, 0, true};
  float a_base = 0.0f + np_pairwise(every, n);
  int x = root;
  for (int d = 0; d + 1 < src.D; ++d) {
    bool any = false;
    int bmin = I32_MAX, bmax = -1;
    for (int e = 0; e < n; ++e) {
      const int32_t* l = src.lin(u[e * s]);
      const int32_t br = l[d + 1] != NONE && l[d] == x ? l[d + 1] : NONE;
      col[e * s] = br;
      if (br != NONE) {
        any = true;
        bmin = min(bmin, br);
        bmax = max(bmax, br);
      }
    }
    if (!any) break;  // nothing below x: stop
    if (bmin == bmax) {  // one branch: descend, no factor test
      x = bmin;
    } else {
      float mx = -INFINITY;
      int best = I32_MAX;
      for (int e = 0; e < n; ++e) {
        const int br = col[e * s];
        if (br == NONE) continue;
        bool seen = false;  // summed at its first slot
        for (int f = 0; f < e && !seen; ++f) seen = col[f * s] == br;
        if (seen) continue;
        int nb = 0;
        for (int f = e; f < n; ++f) nb += col[f * s] == br;
        ListCursor one{col, c, s, br, e, false};
        const float sum = 0.0f + np_pairwise(one, nb);
        if (sum > mx || (sum == mx && br < best)) {
          mx = sum;
          best = br;
        }
      }
      if ((mx / a_base) < factor) break;  // the heaviest share is too low
      x = best;
      a_base = mx;
    }
    int m = 0;
    for (int e = 0; e < n; ++e) {
      if (col[e * s] != x) continue;
      u[m * s] = u[e * s];
      c[m * s] = c[e * s];
      ++m;
    }
    n = m;
  }
  return x;
}

// ---- the thread path: one thread, one group of n <= kThreadCap slots - //
template <int STRAT>
__device__ int thread_group(const Rows& src, int n, const int* tu,
                            const float* tc, const int* td, int root,
                            float factor) {
  const int D = src.D;
#define LIN(e) src.lin(tu[(e) * 32])
  if (STRAT == kHybrid) {
    float a_base = 0.0f;
    for (int e = 0; e < n; ++e) a_base += tc[e * 32];
    int x = root;
    for (int d = 0; d + 1 < D; ++d) {
      bool any = false;
      int bmin = I32_MAX, bmax = -1;  // as the plain version's
      for (int e = 0; e < n; ++e) {
        const int32_t* l = LIN(e);
        const int32_t br = l[d + 1];
        if (br != NONE && l[d] == x) {
          any = true;
          bmin = min(bmin, br);
          bmax = max(bmax, br);
        }
      }
      if (!any) break;  // nothing below x: stop
      if (bmin == bmax) {  // one branch: descend, no factor test
        x = bmin;
        continue;
      }
      float mx = -INFINITY;
      int best = I32_MAX;
      for (int e = 0; e < n; ++e) {
        const int32_t* l = LIN(e);
        const int32_t br = l[d + 1];
        if (br == NONE || l[d] != x) continue;
        float s = 0.0f;
        for (int f = 0; f < n; ++f)
          if (LIN(f)[d + 1] == br) s += tc[f * 32];
        if (s > mx || (s == mx && br < best)) {
          mx = s;
          best = br;
        }
      }
      if ((mx / a_base) < factor) break;  // the heaviest share is too low
      x = best;
      a_base = mx;
    }
    return x;
  }
  if (STRAT == kMrtl) {
    float bs = -INFINITY;
    int bd = -1, bu = I32_MAX;
    for (int e = 0; e < n; ++e) {
      const int ue = tu[e * 32], de = td[e * 32];
      const int32_t* le = LIN(e);
      float s = 0.0f;
      for (int f = 0; f < n; ++f)
        if (src.anc(tu[f * 32], td[f * 32], le)) s += tc[f * 32];
      if (s > bs || (s == bs && (de > bd || (de == bd && ue < bu)))) {
        bs = s;
        bd = de;
        bu = ue;
      }
    }
    return bu;  // I32_MAX when no slot is valid
  }
  // lca*: the deepest dominated slot (first on ties) ...
  int bd = -1, res = 0;
  for (int e = 0; e < n; ++e) {
    const int ue = tu[e * 32], de = td[e * 32];
    const int32_t* le = LIN(e);
    bool dom = true;
    for (int f = 0; f < n && dom; ++f)
      dom = src.anc(tu[f * 32], td[f * 32], le);
    if (dom && de > bd) {
      bd = de;
      res = ue;
    }
  }
  if (bd >= 0) return res;
  // ... else the deepest depth where every valid lineage agrees with the
  // first valid one (slot 0's row, table row 0, when there is none)
  const int32_t* ref = src.lin(n ? tu[0] : 0);
  int dstar = 0;
  for (int d = 0; d < D; ++d) {
    const int32_t r = ref[d];
    bool ok = r != NONE;
    for (int e = 0; e < n && ok; ++e) ok = LIN(e)[d] == r;
    if (ok) dstar = d;
  }
  return ref[dstar];
#undef LIN
}

// ---- the warp path: one group of any count of valid slots ------------ //
template <int STRAT, bool ORD>
__device__ void warp_group(const Rows& src, long long b,
                           const float* __restrict__ counts,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ utaxa, int K,
                           int root, float factor, unsigned char* base,
                           const Store& st) {
  const int D = src.D;
  const int lane = threadIdx.x & 31;
  int* Lk = reinterpret_cast<int*>(base);
  int* Lu = Lk + K;
  float* Lc = reinterpret_cast<float*>(Lu + K);
  int* Ld = reinterpret_cast<int*>(Lc + K);
  int* Lcol = Ld + K;

  // compact the valid slots in slot order with ballots
  const uint8_t* vrow = valid + b * K;
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool v = k < K && vrow[k] != 0;
    const unsigned bal = __ballot_sync(FULL, v);
    if (v) Lk[n + __popc(bal & ((1u << lane) - 1u))] = k;
    n += __popc(bal);
  }
  const int nv = n;  // the group's valid slots (hybrid narrows n below)
  __syncwarp();
  for (int p = lane; p < n; p += 32) {
    const int k = Lk[p];
    const int u = utaxa[b * K + k];
    Lu[p] = u;
    Lc[p] = STRAT != kLca ? counts[b * K + k] : 0.0f;
    Ld[p] = STRAT != kHybrid ? src.depth(u) : 0;
  }
  __syncwarp();

  if (STRAT == kHybrid && ORD) {  // one lane, as TreeMix adds
    if (lane == 0)
      st.put(b, nv, hybrid_ordered(src, n, Lu, Lc, Lcol, 1, root, factor));
    return;
  }
  if (STRAT == kHybrid) {
    float a_base;
    float part = 0.0f;
    for (int p = lane; p < n; p += 32) part += Lc[p];
    a_base = warp_sum_f(part);
    int x = root;
    for (int d = 0; d + 1 < D; ++d) {
      bool any = false;
      int bmin = I32_MAX, bmax = -1;
      for (int p = lane; p < n; p += 32) {
        const int32_t* l = src.lin(Lu[p]);
        const int32_t br = l[d + 1];
        Lcol[p] = br;
        if (br != NONE && l[d] == x) {
          any = true;
          bmin = min(bmin, br);
          bmax = max(bmax, br);
        }
      }
      if (!__any_sync(FULL, any)) break;
      bmin = warp_min_i(bmin);
      bmax = warp_max_i(bmax);
      __syncwarp();
      if (bmin != bmax) {
        float mx = -INFINITY;
        int best = I32_MAX;
        for (int p = lane; p < n; p += 32) {
          const int32_t br = Lcol[p];
          if (br == NONE || src.lin(Lu[p])[d] != x) continue;
          float s = 0.0f;
          for (int q = 0; q < n; ++q)
            if (Lcol[q] == br) s += Lc[q];
          if (s > mx || (s == mx && br < best)) {
            mx = s;
            best = br;
          }
        }
        const float m = warp_max_f(mx);
        best = warp_min_i(mx == m ? best : I32_MAX);
        if ((m / a_base) < factor) break;
        x = best;
        a_base = m;
      } else {
        x = bmin;
      }
      // keep only the slots under the new x (branch == x), in slot
      // order: no other slot lies below x at a later depth or shares a
      // branch with one that does (equal ancestors at depth d + 1 have
      // equal ancestors above), so the walk's later depths read only
      // x's subtree
      __syncwarp();
      int m = 0;
      for (int p0 = 0; p0 < n; p0 += 32) {
        const int p = p0 + lane;
        const bool keep = p < n && Lcol[p] == x;
        const int u = keep ? Lu[p] : 0;
        const float c = keep ? Lc[p] : 0.0f;
        const unsigned bal = __ballot_sync(FULL, keep);
        __syncwarp();  // the chunk is read before any lane writes
        if (keep) {
          const int q = m + __popc(bal & ((1u << lane) - 1u));
          Lu[q] = u;
          Lc[q] = c;
        }
        m += __popc(bal);
      }
      n = m;
      __syncwarp();  // Lcol is rewritten at the next depth
    }
    if (lane == 0) st.put(b, nv, x);
    return;
  }
  if (STRAT == kMrtl) {
    float bs = -INFINITY;
    int bd = -1, bu = I32_MAX;
    for (int p = lane; p < n; p += 32) {
      const int32_t* lp = src.lin(Lu[p]);
      float s = 0.0f;
#pragma unroll 8  // kAncBatch
      for (int q = 0; q < n; ++q)
        if (src.anc(Lu[q], Ld[q], lp)) s += Lc[q];
      const int dp = Ld[p], up = Lu[p];
      if (s > bs || (s == bs && (dp > bd || (dp == bd && up < bu)))) {
        bs = s;
        bd = dp;
        bu = up;
      }
    }
    const float smax = warp_max_f(bs);
    const int dmax = warp_max_i(bs == smax ? bd : -1);
    bu = warp_min_i(bs == smax && bd == dmax ? bu : I32_MAX);
    if (lane == 0) st.put(b, nv, bu);
    return;
  }
  // lca*
  int bd = -1, bp = I32_MAX;
  for (int p = lane; p < n; p += 32) {
    const int32_t* lp = src.lin(Lu[p]);
    bool dom = true;
    for (int q0 = 0; q0 < n && dom; q0 += kAncBatch) {
#pragma unroll
      for (int q = q0; q < q0 + kAncBatch; ++q)
        if (q < n) dom = src.anc(Lu[q], Ld[q], lp) & dom;
    }
    if (dom && Ld[p] > bd) {
      bd = Ld[p];
      bp = p;
    }
  }
  const int dmax = warp_max_i(bd);
  const int pstar = warp_min_i(bd == dmax ? bp : I32_MAX);
  if (dmax >= 0) {
    if (lane == 0) st.put(b, nv, Lu[pstar]);
    return;
  }
  const int32_t* ref = src.lin(n ? Lu[0] : 0);
  int dstar = 0;
  for (int d = 0; d < D; ++d) {
    const int32_t r = ref[d];
    bool ok = r != NONE;
    for (int p = lane; p < n && ok; p += 32) ok = src.lin(Lu[p])[d] == r;
    if (__all_sync(FULL, ok)) dstar = d;
  }
  if (lane == 0) st.put(b, nv, ref[dstar]);
}

template <int STRAT, bool ORD>
__global__ void tree_kernel(Rows src, const float* __restrict__ counts,
                            const uint8_t* __restrict__ valid,
                            const int32_t* __restrict__ utaxa, int B, int K,
                            int root, float factor,
                            unsigned char* __restrict__ scratch,
                            Store st) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned heavy_groups;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b0 = (long long)blockIdx.x * 32;
  if (w == 0) {  // the thread path, a lane a group
    const long long b = b0 + lane;
    int* tk = reinterpret_cast<int*>(smem) + lane;
    int* tu = tk + kThreadCap * 32;
    float* tc = reinterpret_cast<float*>(tu + kThreadCap * 32);
    int* td = reinterpret_cast<int*>(tc + kThreadCap * 32);
    bool heavy = false;
    if (b < B) {
      const int n = scan_mask(valid + b * K, K, kThreadCap, tk, 32);
      if (n > kThreadCap) {
        heavy = true;
      } else {
#pragma unroll
        for (int e = 0; e < kThreadCap; ++e) {
          if (e < n) {
            const int k = tk[e * 32];
            const int u = utaxa[b * K + k];
            tu[e * 32] = u;
            tc[e * 32] = STRAT != kLca ? counts[b * K + k] : 0.0f;
            td[e * 32] = STRAT != kHybrid ? src.depth(u) : 0;
          }
        }
        st.put(b, n,
               ORD && STRAT == kHybrid
                   ? hybrid_ordered(src, n, tu, tc, td, 32, root, factor)
               : STRAT == kHybrid && n <= kSmall
                   ? hybrid_small(src, n, tu, tc, root, factor)
                   : thread_group<STRAT>(src, n, tu, tc, td, root, factor));
      }
    }
    const unsigned h = __ballot_sync(FULL, heavy);
    if (lane == 0) heavy_groups = h;
  }
  __syncthreads();  // the thread lists are done with: the warp path reuses
  unsigned todo = heavy_groups;
  const int warps = blockDim.x >> 5;
  unsigned char* base =
      scratch ? scratch + ((size_t)blockIdx.x * warps + w) * list_bytes(K)
              : smem + (size_t)w * list_bytes(K);
  for (int r = 0; todo; ++r) {  // the block's larger groups, dealt out
    const int t = __ffs(todo) - 1;
    todo &= todo - 1;
    if (r % warps != w) continue;
    warp_group<STRAT, ORD>(src, b0 + t, counts, valid, utaxa, K, root,
                           factor, base, st);
    __syncwarp();
  }
}

template <int STRAT, bool ORD>
int launch(const Rows& src, const float* counts, const uint8_t* valid,
           const int32_t* utaxa, int B, int K, int root, float factor,
           unsigned char* scratch, const Store& st, cudaStream_t stream) {
  int warps = kBlockWarps;  // fewer where the lists of a wide K need it
  size_t smem = kThreadBytes;
  if (list_bytes(K) <= kSmemMax) {
    scratch = nullptr;
    while (warps > 1 && list_bytes(K) * warps > kSmemMax) --warps;
    const size_t lists = list_bytes(K) * warps;
    if (lists > smem) smem = lists;
  } else if (scratch == nullptr) {  // the lists need the global scratch
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_kernel<STRAT, ORD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)(((long long)B + 31) / 32);
  tree_kernel<STRAT, ORD><<<blocks, 32 * warps, smem, stream>>>(
      src, counts, valid, utaxa, B, K, root, factor, scratch, st);
  return (int)cudaGetLastError();
}

// ---- the block path: a block a group of K > kWideK slots -------------- //

// Bytes of one block's list of K slots: ids, counts, a third word.
__host__ __device__ inline size_t block_list_bytes(int K) {
  return (size_t)12 * (((size_t)K + 3) & ~(size_t)3);
}

// The block's reduction words (static shared memory).
struct BlockRed {
  int i[32];
  int j[32];
  float f[32];
  unsigned long long m[32];
  int scan[2][32];  // block_scan's warp totals, by call parity
  int fill;         // hybrid: branches in the table this pass
};

// Exclusive prefix of v over the block's threads in thread order; the
// block's total in *total. One barrier: every read before the call
// precedes every write after it. The warp totals alternate between two
// buffers (*parity, the same in every thread), so a call's buffer is
// written again only after the next call's barrier.
__device__ int block_scan(int v, BlockRed& r, int* total, int* parity) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  int* wt = r.scan[*parity];
  *parity ^= 1;
  if (lane == 31) wt[w] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int t = wt[k];
    before += k < w ? t : 0;
    all += t;
  }
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ bool better(float s1, int d1, int u1, float s2,
                                       int d2, int u2) {
  return s1 > s2 || (s1 == s2 && (d1 > d2 || (d1 == d2 && u1 < u2)));
}

// The block's best (max s, then max d, then min u), in every thread.
__device__ void block_best(float& s, int& d, int& u, BlockRed& r) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(FULL, s, o);
    const int d2 = __shfl_xor_sync(FULL, d, o);
    const int u2 = __shfl_xor_sync(FULL, u, o);
    if (better(s2, d2, u2, s, d, u)) {
      s = s2;
      d = d2;
      u = u2;
    }
  }
  if (lane == 0) {
    r.f[w] = s;
    r.i[w] = d;
    r.j[w] = u;
  }
  __syncthreads();
  s = r.f[0];
  d = r.i[0];
  u = r.j[0];
  for (int k = 1; k < kWarps; ++k)
    if (better(r.f[k], r.i[k], r.j[k], s, d, u)) {
      s = r.f[k];
      d = r.i[k];
      u = r.j[k];
    }
  __syncthreads();
}

__device__ void block_min_max(int& lo, int& hi, BlockRed& r) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  if (lane == 0) {
    r.i[w] = lo;
    r.j[w] = hi;
  }
  __syncthreads();
  for (int k = 0; k < kWarps; ++k) {
    lo = min(lo, r.i[k]);
    hi = max(hi, r.j[k]);
  }
  __syncthreads();
}

__device__ float block_sum(float v, BlockRed& r) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum_f(v);
  if (lane == 0) r.f[w] = v;
  __syncthreads();
  v = 0.0f;
  for (int k = 0; k < kWarps; ++k) v += r.f[k];
  __syncthreads();
  return v;
}

__device__ unsigned long long block_and(unsigned long long v, BlockRed& r) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lo = __reduce_and_sync(FULL, (unsigned)v);
  const unsigned hi = __reduce_and_sync(FULL, (unsigned)(v >> 32));
  if (lane == 0) r.m[w] = ((unsigned long long)hi << 32) | lo;
  __syncthreads();
  v = ~0ull;
  for (int k = 0; k < kWarps; ++k) v &= r.m[k];
  __syncthreads();
  return v;
}

// bit j set where byte j of w is nonzero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u);
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

// The group's valid slots in slot order: ids to A, counts to C (1 for
// lca*, whose counts may be null). A thread takes a piece of the mask
// (the unaligned head, a 16-byte load, the tail); a block scan of the
// pieces' counts places its slots. Returns the count, in every thread.
template <int STRAT>
__device__ int compact_group(const uint8_t* __restrict__ vrow,
                             const int32_t* __restrict__ urow,
                             const float* __restrict__ crow, int K, int* A,
                             float* C, BlockRed& r, int* parity) {
  const int head = min(K, (int)((16 - ((uintptr_t)vrow & 15)) & 15));
  const int body = (K - head) >> 4;
  const int pieces = body + 2;  // head, the 16-byte body, tail
  int n = 0;
  for (int q0 = 0; q0 < pieces; q0 += kBlockThreads) {
    const int q = q0 + threadIdx.x;
    unsigned bits = 0;
    int base = 0;
    if (q == 0) {
      for (int j = 0; j < head; ++j) bits |= (unsigned)(vrow[j] != 0) << j;
    } else if (q <= body) {
      base = head + ((q - 1) << 4);
      const uint4 v = *reinterpret_cast<const uint4*>(vrow + base);
      bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
             nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
    } else if (q < pieces) {
      base = head + (body << 4);
      for (int j = 0; base + j < K; ++j)
        bits |= (unsigned)(vrow[base + j] != 0) << j;
    }
    int total;
    int pos = n + block_scan(__popc(bits), r, &total, parity);
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // the piece's loads issued together
      if (bits >> j & 1u) {
        A[pos] = urow[base + j];
        C[pos] = STRAT == kLca ? 1.0f : crow[base + j];
        ++pos;
      }
    }
    n += total;
  }
  __syncthreads();  // the list is complete
  return n;
}

// Sorts A ascending, C along: a bitonic network whose comparators all put
// the smaller key at the lower index, so positions from n on act as +inf
// and their comparators are skipped.
__device__ void block_sort(int* A, float* C, int n) {
  int N = 1;
  while (N < n) N <<= 1;
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (N >> 1); t += kBlockThreads) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = j == (k >> 1) ? lo ^ (k - 1) : lo + j;
        if (hi < n && A[hi] < A[lo]) {
          const int a = A[lo];
          A[lo] = A[hi];
          A[hi] = a;
          const float c = C[lo];
          C[lo] = C[hi];
          C[hi] = c;
        }
      }
      __syncthreads();
    }
  }
}

// Folds runs of equal ids of the sorted list into one entry each, in
// place: the id (A), its summed counts or multiplicity (C) and its clamped
// depth min(max(row[0], 0), D - 1) (X). Returns the distinct count.
__device__ int fold_ids(const Rows& src, int* A, float* C, int* X, int n,
                        BlockRed& r, int* parity) {
  int m = 0;
  for (int p0 = 0; p0 < n; p0 += kBlockThreads) {
    const int p = p0 + threadIdx.x;
    bool head = false;
    int u = 0;
    float s = 0.0f;
    if (p < n) {
      u = A[p];
      head = p == 0 || A[p - 1] != u;
      if (head)
        for (int q = p; q < n && A[q] == u; ++q) s += C[q];
    }
    int total;
    const int pos = m + block_scan(head, r, &total, parity);  // reads done
    if (head) {  // pos <= p: the rounds ahead are not touched
      A[pos] = u;
      C[pos] = s;
      X[pos] = min(src.depth(u), src.D - 1);
    }
    m += total;
    __syncthreads();
  }
  return m;
}

constexpr int kSearches = 4;  // lineage entries searched together

// mrtl (the best id) and lca* (the deepest dominated id; *found false
// when none is) over the folded list, in every thread. score(j) = sum
// over the depths d of the entry at lin_j[d] whose clamped depth is d,
// found by kSearches interleaved branch-free searches (the largest
// index below the value, by halving steps from top, the largest power
// of 2 not above m).
template <int STRAT>
__device__ int score_ids(const Rows& src, const int* U, const float* S,
                         const int* X, int m, int n, BlockRed& r,
                         bool* found) {
  float bs = -INFINITY;
  int bd = -1, bu = I32_MAX;
  int top = 1;
  while (top * 2 <= m) top *= 2;
  const int lo = U[0], hi = U[m - 1];
  for (int e = threadIdx.x; e < m; e += kBlockThreads) {
    const int u = U[e];
    const int32_t* l = src.lin(u);
    float s = 0.0f;
    for (int d0 = 0; d0 < src.D; d0 += kSearches) {
      int v[kSearches], pos[kSearches];
#pragma unroll
      for (int k = 0; k < kSearches; ++k) {
        v[k] = d0 + k < src.D ? l[d0 + k] : 0;
        pos[k] = -1;
      }
      bool inside = false;  // a value outside [U[0], U[m - 1]] is absent
#pragma unroll
      for (int k = 0; k < kSearches; ++k)
        inside = inside || (d0 + k < src.D && v[k] >= lo && v[k] <= hi);
      for (int step = inside ? top : 0; step > 0; step >>= 1) {
#pragma unroll
        for (int k = 0; k < kSearches; ++k) {
          const int q = pos[k] + step;
          if (q < m && U[q] < v[k]) pos[k] = q;
        }
      }
#pragma unroll
      for (int k = 0; k < kSearches; ++k) {
        const int i = pos[k] + 1;
        if (d0 + k < src.D && i < m && U[i] == v[k] && X[i] == d0 + k)
          s += S[i];
      }
    }
    const int du = max(l[-1], 0);
    // lca*: only a dominated id competes, on depth, then id
    const float key = STRAT == kLca ? (s == (float)n ? 0.0f : -INFINITY) : s;
    if (better(key, du, u, bs, bd, bu)) {
      bs = key;
      bd = du;
      bu = u;
    }
  }
  block_best(bs, bd, bu, r);
  *found = bs != -INFINITY;
  return bu;
}

// lca* with no dominated slot: the ancestor at the deepest depth where
// every valid lineage agrees with the first valid slot's (depth 0 when
// none does), 64 depths a block reduction.
__device__ int agree_ids(const Rows& src, const int* U, int m, int first,
                         BlockRed& r) {
  const int32_t* ref = src.lin(first);
  int dstar = 0;
  for (int d0 = 0; d0 < src.D; d0 += 64) {
    const int nd = min(64, src.D - d0);
    unsigned long long ok = nd == 64 ? ~0ull : (1ull << nd) - 1;
    for (int d = 0; d < nd; ++d)
      if (ref[d0 + d] == NONE) ok &= ~(1ull << d);
    for (int e = threadIdx.x; e < m && ok; e += kBlockThreads) {
      const int32_t* l = src.lin(U[e]);
      for (int d = 0; d < nd; ++d)
        if (l[d0 + d] != ref[d0 + d]) ok &= ~(1ull << d);
    }
    ok = block_and(ok, r);
    if (ok) dstar = d0 + 63 - __clzll(ok);
  }
  return ref[dstar];
}

// mrtl as RmqRTL adds (ordered instances): each j of the list scores the
// slots i with lin_j[dep_i] == id_i one at a time in list order, the
// first-seen order of K4's weighted slots; the block's best (score,
// depth, -id), in every thread.
__device__ int score_slots(const Rows& src, const int* A, const float* C,
                           int* X, int n, BlockRed& r) {
  for (int p = threadIdx.x; p < n; p += kBlockThreads)
    X[p] = min(src.depth(A[p]), src.D - 1);
  __syncthreads();
  float bs = -INFINITY;
  int bd = -1, bu = I32_MAX;
  for (int e = threadIdx.x; e < n; e += kBlockThreads) {
    const int u = A[e];
    const int32_t* l = src.lin(u);
    float s = 0.0f;
    for (int i = 0; i < n; ++i)
      if (l[X[i]] == A[i]) s += C[i];
    const int du = max(l[-1], 0);
    if (better(s, du, u, bs, bd, bu)) {
      bs = s;
      bd = du;
      bu = u;
    }
  }
  block_best(bs, bd, bu, r);
  return bu;
}

__device__ __forceinline__ int hash_slot(int key) {
  return (int)(((unsigned)key * 0x9E3779B1u) >> 21) & (kHashSlots - 1);
}

// hybrid's descent over the group's list (A ids, C counts, X branches).
// Each depth's pass keeps, in place, the slots under x (lin[d] == x; all
// at depth 0), so the list follows x's subtree down.
__device__ int hybrid_block(const Rows& src, int* A, float* C, int* X, int n,
                            int root, float factor, int* hk, float* hs,
                            BlockRed& r, int* parity) {
  const int D = src.D;
  float a_base;
  float part = 0.0f;
  for (int p = threadIdx.x; p < n; p += kBlockThreads) part += C[p];
  a_base = block_sum(part, r);
  int x = root;
  for (int d = 0; d + 1 < D; ++d) {
    bool any = false;
    int bmin = I32_MAX, bmax = -1;
    int m = 0;
    for (int p0 = 0; p0 < n; p0 += kBlockThreads) {
      const int p = p0 + threadIdx.x;
      bool keep = false, below = false;
      int u = 0, br = NONE;
      float c = 0.0f;
      if (p < n) {
        u = A[p];
        c = C[p];
        const int32_t* l = src.lin(u);
        const bool under = l[d] == x;
        br = l[d + 1];
        keep = d == 0 || under;
        below = under && br != NONE;
      }
      int total;
      const int q = m + block_scan(keep, r, &total, parity);  // reads done
      if (keep) {
        A[q] = u;
        C[q] = c;
        X[q] = below ? br : NONE;
      }
      if (below) {
        any = true;
        bmin = min(bmin, br);
        bmax = max(bmax, br);
      }
      m += total;
    }
    n = m;
    if (!__syncthreads_or(any)) break;  // nothing below x: stop
    block_min_max(bmin, bmax, r);
    if (bmin == bmax) {  // one branch: descend, no factor test
      x = bmin;
      continue;
    }
    // the branch sums, in passes of at most kHashFill new branches; an
    // entry is done once its count is in (X set to NONE)
    float mx = -INFINITY;
    int best = I32_MAX;
    for (;;) {
      for (int t = threadIdx.x; t < kHashSlots; t += kBlockThreads) {
        hk[t] = NONE;
        hs[t] = 0.0f;
      }
      if (threadIdx.x == 0) r.fill = 0;
      __syncthreads();
      bool more = false;
      volatile int* vk = hk;
      volatile int* vfill = &r.fill;
      const int lane = threadIdx.x & 31;
      for (int p0 = 0; p0 < n; p0 += kBlockThreads) {
        // a warp's entries of one branch are summed first and go in with
        // one atomic (a few branches hold thousands of entries near the
        // root, whose atomics on one word would run one after another)
        const int p = p0 + threadIdx.x;
        const int br = p < n ? X[p] : NONE;
        const float c = br != NONE ? C[p] : 0.0f;
        const unsigned peers = __match_any_sync(FULL, br);
        float sum = 0.0f;
        for (int k = 0; k < 32; ++k) {
          const float ck = __shfl_sync(FULL, c, k);
          if (peers >> k & 1u) sum += ck;
        }
        const int leader = __ffs(peers) - 1;
        bool in = false;
        if (br != NONE && lane == leader) {
          for (int h = hash_slot(br);; h = (h + 1) & (kHashSlots - 1)) {
            const int k = vk[h];
            if (k == NONE) {
              if (*vfill >= kHashFill) break;  // looked up below
              const int old = atomicCAS(hk + h, NONE, br);
              if (old == NONE) atomicAdd(&r.fill, 1);
              if (old != NONE && old != br) continue;
            } else if (k != br) {
              continue;
            }
            atomicAdd(hs + h, sum);
            in = true;
            break;
          }
        }
        if (__shfl_sync(FULL, in, leader)) X[p] = NONE;
      }
      __syncthreads();
      // the table is final: the entries left look their branch up
      for (int p = threadIdx.x; p < n; p += kBlockThreads) {
        const int br = X[p];
        if (br == NONE) continue;
        int h = hash_slot(br);
        while (hk[h] != NONE && hk[h] != br) h = (h + 1) & (kHashSlots - 1);
        if (hk[h] == br) {
          atomicAdd(hs + h, C[p]);
          X[p] = NONE;
        } else {
          more = true;  // a later pass
        }
      }
      __syncthreads();
      float s = -INFINITY;
      int dz = 0, bb = I32_MAX;
      for (int t = threadIdx.x; t < kHashSlots; t += kBlockThreads)
        if (hk[t] != NONE && better(hs[t], 0, hk[t], s, 0, bb)) {
          s = hs[t];
          bb = hk[t];
        }
      block_best(s, dz, bb, r);
      if (better(s, 0, bb, mx, 0, best)) {
        mx = s;
        best = bb;
      }
      if (!__syncthreads_or(more)) break;
    }
    if ((mx / a_base) < factor) break;  // the heaviest share is too low
    x = best;
    a_base = mx;
  }
  return x;
}

template <int STRAT, bool ORD>
__global__ void __launch_bounds__(kBlockThreads)
    tree_block_kernel(Rows src, const float* __restrict__ counts,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ utaxa, int B, int K,
                      int root, float factor,
                      unsigned char* __restrict__ scratch, Store st) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BlockRed red;
  const size_t Kp = ((size_t)K + 3) & ~(size_t)3;
  unsigned char* list = scratch
                            ? scratch + (size_t)blockIdx.x * block_list_bytes(K)
                            : smem + kAuxBytes;
  int* A = reinterpret_cast<int*>(list);
  float* C = reinterpret_cast<float*>(A + Kp);
  int* X = reinterpret_cast<int*>(C + Kp);
  int* hk = reinterpret_cast<int*>(smem);
  float* hs = reinterpret_cast<float*>(hk + kHashSlots);
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    int parity = 0;
    const int n = compact_group<STRAT>(valid + b * K, utaxa + b * K,
                                       STRAT == kLca ? nullptr : counts + b * K,
                                       K, A, C, red, &parity);
    int res = 0;
    if (n <= kThreadCap) {  // the thread path's walk, on thread 0
      if (threadIdx.x == 0) {
        int* tu = hk;
        float* tc = reinterpret_cast<float*>(tu + kThreadCap * 32);
        int* td = reinterpret_cast<int*>(tc + kThreadCap * 32);
        for (int e = 0; e < n; ++e) {
          tu[e * 32] = A[e];
          tc[e * 32] = STRAT != kLca ? C[e] : 0.0f;
          td[e * 32] = STRAT != kHybrid ? src.depth(A[e]) : 0;
        }
        res = ORD && STRAT == kHybrid
                  ? hybrid_ordered(src, n, tu, tc, td, 32, root, factor)
              : STRAT == kHybrid && n <= kSmall
                  ? hybrid_small(src, n, tu, tc, root, factor)
                  : thread_group<STRAT>(src, n, tu, tc, td, root, factor);
      }
    } else if (ORD && STRAT == kHybrid) {  // one thread, as TreeMix adds
      if (threadIdx.x == 0)
        res = hybrid_ordered(src, n, A, C, X, 1, root, factor);
    } else if (STRAT == kHybrid) {
      res = hybrid_block(src, A, C, X, n, root, factor, hk, hs, red,
                         &parity);
    } else if (ORD && STRAT == kMrtl) {
      res = score_slots(src, A, C, X, n, red);
    } else {
      const int first = A[0];  // the first valid slot's id
      bool ascending = true;
      for (int p = threadIdx.x + 1; p < n; p += kBlockThreads)
        ascending = ascending && A[p - 1] < A[p];
      int m = n;
      if (__syncthreads_and(ascending)) {  // distinct already (K4's lists)
        for (int p = threadIdx.x; p < n; p += kBlockThreads)
          X[p] = min(src.depth(A[p]), src.D - 1);
        __syncthreads();
      } else {
        block_sort(A, C, n);
        m = fold_ids(src, A, C, X, n, red, &parity);
      }
      // an id dominated by every slot has each distinct id at its own
      // depth in its lineage: none is past D distinct ids
      bool found = false;
      if (STRAT == kMrtl || m <= src.D)
        res = score_ids<STRAT>(src, A, C, X, m, n, red, &found);
      if (STRAT == kLca && !found) res = agree_ids(src, A, m, first, red);
    }
    if (threadIdx.x == 0) st.put(b, n, res);
    __syncthreads();  // the list and the auxiliary area are reused
  }
}

template <int STRAT, bool ORD>
int launch_block(const Rows& src, const float* counts, const uint8_t* valid,
                 const int32_t* utaxa, int B, int K, int root, float factor,
                 unsigned char* scratch, int scratch_blocks, const Store& st,
                 cudaStream_t stream) {
  size_t smem = kAuxBytes;
  int grid = B < kBlockGrid ? B : kBlockGrid;
  if (kAuxBytes + block_list_bytes(K) <= kSmemMax) {
    smem += block_list_bytes(K);
    scratch = nullptr;
  } else if (scratch == nullptr || scratch_blocks < 1) {
    return (int)cudaErrorInvalidValue;  // the lists need the scratch
  } else if (scratch_blocks < grid) {
    grid = scratch_blocks;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_block_kernel<STRAT, ORD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tree_block_kernel<STRAT, ORD><<<grid, kBlockThreads, smem, stream>>>(
      src, counts, valid, utaxa, B, K, root, factor, scratch, st);
  return (int)cudaGetLastError();
}

template <int STRAT, bool ORD>
int dispatch(const Rows& src, const float* counts, const uint8_t* valid,
             const int32_t* utaxa, int B, int K, int root, float factor,
             unsigned char* scratch, int scratch_blocks, const Store& st,
             cudaStream_t stream) {
  if (K <= kWideK)  // a warp's list fits shared memory: no scratch
    return launch<STRAT, ORD>(src, counts, valid, utaxa, B, K, root,
                              factor, nullptr, st, stream);
  return launch_block<STRAT, ORD>(src, counts, valid, utaxa, B, K, root,
                                  factor, scratch, scratch_blocks, st,
                                  stream);
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strategy: 0 hybrid, 1 lca* (counts unused, may be null), 2 mrtl.
// geom: dtax.geom, size rows of W = 1 + D int32, contiguous. valid (B, K)
// bool, utaxa (B, K) int32, counts (B, K) float32, all contiguous; out
// (B,) int32. K <= 64 takes the thread and warp paths, K > 64 the block
// path. scratch: null while a block's list fits its shared memory
// (kAuxBytes + block_list_bytes(K) <= kSmemMax), else scratch_blocks
// lists of block_list_bytes(K), 16-byte aligned, and the launch runs at
// most scratch_blocks blocks (agg/device.py tree_scratch_bytes). snap:
// null, or the snap table (snap_size int32) the results go through
// (Store::put). ordered: nonzero for counts that are not integers, which
// hybrid and mrtl then add in the plain versions' order (the note at the
// top); lca* reads no counts.
extern "C" int tree_aggregate(int strategy, const void* geom, int size,
                              int W, const void* counts, const void* valid,
                              const void* utaxa, int B, int K, int root,
                              float factor, void* scratch,
                              int scratch_blocks, void* out, const void* snap,
                              int snap_size, int ordered, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || W < 2 || size <= 0 || (snap != nullptr && snap_size <= 0))
    return (int)cudaErrorInvalidValue;
  const Rows src{(const int32_t*)geom, size, W, W - 1};
  const float* c = (const float*)counts;
  const uint8_t* v = (const uint8_t*)valid;
  const int32_t* u = (const int32_t*)utaxa;
  unsigned char* sc = (unsigned char*)scratch;
  const Store o{(int32_t*)out, (const int32_t*)snap, snap_size};
  cudaStream_t s = (cudaStream_t)stream;
  switch (strategy) {
    case kHybrid:
      return ordered ? dispatch<kHybrid, true>(src, c, v, u, B, K, root,
                                               factor, sc, scratch_blocks, o,
                                               s)
                     : dispatch<kHybrid, false>(src, c, v, u, B, K, root,
                                                factor, sc, scratch_blocks,
                                                o, s);
    case kLca:
      return dispatch<kLca, false>(src, c, v, u, B, K, root, factor, sc,
                                   scratch_blocks, o, s);
    case kMrtl:
      return ordered ? dispatch<kMrtl, true>(src, c, v, u, B, K, root,
                                             factor, sc, scratch_blocks, o,
                                             s)
                     : dispatch<kMrtl, false>(src, c, v, u, B, K, root,
                                              factor, sc, scratch_blocks, o,
                                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tree_aggregate_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return tree_aggregate((int)a.i(0), a.ptr(1), (int)a.i(2), (int)a.i(3),
                        a.ptr(4), a.ptr(5), a.ptr(6), (int)a.i(7),
                        (int)a.i(8), (int)a.i(9), (float)a.d(10), a.ptr(11),
                        (int)a.i(12), a.ptr(13), a.ptr(14), (int)a.i(15),
                        (int)a.i(16), a.ptr(17));
}
