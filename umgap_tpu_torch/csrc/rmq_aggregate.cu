// K9 rmq_aggregate: the Euler/RMQ aggregators over a read group's
// deduplicated hit list, with taxa2agg's snap at the store, one launch a
// batch:
//   lca*   (rmq::lca): the join-level walk over the Euler tour's RMQ;
//   hybrid (rmq::mix): the LCA closure of the hits, scored by factor f.
//
// Replaces umgap_tpu/agg/device_rmq.py:120 rmq_lca_batch (a lax.scan over
// the K slots, :154, of rmq_query_batch, :85) and :158 rmq_mix_batch (the
// pairwise agreement counts, two sorts of the K + K^2 candidates and the
// one-hot einsums at :208 and :216), with umgap_tpu/agg/device.py:308
// snap_batch and the where over uvalid.any (umgap_tpu/pipeline/fused.py:
// 122-124) fused into the store. As PyTorch around K5 (the plain
// versions, agg/device_rmq.py) lca* launched K5 five times and about
// thirty elementwise kernels for each of the K = 64 slots, hybrid built
// (B, K, K) tensors over D lineage columns and sorted (B, K + K^2) twice;
// a batch of 16,384 groups took 122.4 / 40.7 ms on an H100.
//
// Semantics kept exactly (the plain versions, agg/device_rmq.py
// rmq_aggregate_plain):
//   lca*: occ_j = max(first[clamp(u_j)], 0) for each valid slot j; the
//     walk starts at the first valid slot's occ (slot 0's, with safe id 0,
//     when none is valid) and takes the valid slots after it in slot
//     order, skipping one whose occ equals the consensus: rmq = the
//     reference's RMQ::query position (agg/rmq.py: the leftmost minimum
//     inside a 64-block; across blocks the left part, the block-min or
//     sparse-table middle and the right part, each pick by <= as
//     rmq_query_batch orders them); the LCA is rmq unless rmq is one of
//     the two ends, then the other end; a join (neither end) sets the
//     join level to rmq's depth; an LCA deeper than the join level set
//     before the step is demoted to rmq. The result is tour[consensus].
//   hybrid: the candidates are the valid inputs and the LCA of every
//     valid pair, self pairs included (lin_i[agree - 1], 0 where the two
//     lineages agree nowhere), without I32_MAX, and without -1 when it is
//     the smallest (the plain version's run heads start from -1), the 2K
//     smallest distinct kept; candidate v (depth dv = max(depth[clamp(v)],
//     0)) weighs lca_w = the counts of inputs j with lin_j[dv] == v and
//     rtl_w = the counts of inputs j with lin_v[dep_j] == u_j, each added
//     from 0.0f one valid slot at a time in slot order (fold_sum's order,
//     which taxa2agg -s needs and which integer counts add exactly in as
//     in any other); score = lca_w * f + rtl_w * (1 - f), each operation
//     rounded on its own (no fused multiply-add); the highest score wins,
//     then the deepest, then the smallest id; I32_MAX when no slot is
//     valid.
//   Snap (Store::put in csrc/tree_aggregate.cu): with a table, 1 for a
//     group with no valid slot, else snap[x] for 0 <= x < S when it is
//     not NONE, else 0; without one (subcommands.py names an unsnappable
//     taxon) the aggregate itself.
//
// What bounds it. Bytes: a group's valid mask (K bytes), each valid
// slot's id (and count for hybrid), the table entries each valid hit needs
// once (its first entry for lca*, its lineage row for hybrid) and 4 bytes
// written: at the bench's 8.2 valid slots of K = 64 under 0.2 KB a group,
// about 1 us for 16,384 groups at 3.35 TB/s, below what one launch of
// that many groups takes. What a group costs in time is a chain of
// dependent steps: lca*'s walk is sequential over the valid slots, each
// step one or two 64-position block scans and up to three dependent table
// loads (L2: the Euler tables are 1.3 MB for the bench's 20,001 taxa,
// about 40 MB at NCBI's 2.5 M); hybrid's is a sort of the lineage rows,
// the candidates' sort and the scoring. So groups are spread over the
// card a warp each, and each step's work over the warp's lanes.
//
// Design, lca*: a group of kLcaLanes lanes (a warp) a group, kLcaGroups
// groups a block. The group reads its mask kLcaLanes slots at a time
// (a ballot), looks up the occ (and its depth) of those valid slots in
// parallel, and walks them in slot order, broadcasting each by a
// shuffle. A step's block scans take 64 / kLcaLanes positions a lane and
// a leftmost-argmin reduction of (depth << 32 | position) keys by
// shuffles; every lane reads the block-min or sparse entries and their
// depths itself (one broadcast load a warp), issued before the scans'
// loads and reductions so that the two chains overlap. Only valid slots
// are walked, at every K.
//
// Design, hybrid: a team (a warp a group up to K = kWarpK, kMixWarps
// groups a block; a block of kMixThreads a group past it, the grid
// striding over the batch) compacts the valid slots in slot order into a
// list (id, clamped id, clamped depth, count) and sorts the list by
// lineage row, lexicographically (a bitonic network; a comparison finds
// the rows' common prefix by a binary search, since on a taxonomy's rows
// a column agrees, and is not NONE, exactly up to the LCA's depth). In
// that DFS order the LCA of any pair is the shallowest LCA of the
// adjacent pairs between them, so the candidates are the n inputs, the n
// self pairs' LCAs and the n - 1 adjacent LCAs: at most 3n - 1 values,
// where the plain version lists K + K^2. They are sorted (a second
// bitonic network); a value's first place is a distinct candidate, and
// its rank among them (a ballot count in order) keeps the 2K smallest,
// as the plain version keeps them. Each lane then scores distinct
// candidates against the list in slot order, the lineage rows read
// through L1 from dtax.geom (a group's rows are a few hundred bytes on
// the bench, read some log n times each; staging them would hold 64 x D
// words of shared memory a warp, 6.6 KB at the bench's D = 26, and
// leave fewer warps resident), and the team's argmax is a shuffle (and
// block) reduction. The lists live in shared memory, mix_area_bytes(cap)
// a team; past kSmemMax a block's list goes to a global scratch that the
// wrapper allocates, and the grid is cut to its blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int32_t I32_MAX = 0x7FFFFFFF;
constexpr int32_t NONE = -1;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kHybrid = 0, kLca = 1;
constexpr int kBlock = 64;       // the RMQ's block (agg/rmq.py BLOCK)
constexpr int kLcaLanes = 32;    // lanes a group on the lca* walk
constexpr int kLcaGroups = 4;    // groups a block on the lca* walk
constexpr int kWarpK = 64;       // widest K of hybrid's warp path
constexpr int kMixWarps = 4;     // groups (a warp each) a block there
constexpr int kMixThreads = 256;  // threads of hybrid's block path
constexpr int kMixGrid = 528;    // most blocks a launch there (4 an SM)
// a block's dynamic shared memory, below the 227 KB a block may hold
// with its static words
constexpr size_t kSmemMax = 226 * 1024;
static_assert(kLcaLanes == 16 || kLcaLanes == 32, "lanes a group");
static_assert(kMixThreads % 32 == 0 && kMixThreads <= 1024, "block");

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// One team's lists for groups of up to `cap` slots: ids, clamped ids,
// clamped depths and counts (cap each), the sort order of the list
// (pow2_at_least(cap)) and the candidates (pow2_at_least(3 cap)).
// agg/device_rmq.py rmq_mix_area_bytes mirrors it.
__host__ __device__ inline size_t mix_area_bytes(int cap) {
  return (size_t)cap * 16 + (size_t)pow2_at_least(cap) * 4 +
         (size_t)pow2_at_least(3 * cap) * 4;
}

__device__ __forceinline__ int32_t put_snap(const int32_t* snap, int S,
                                            bool any, int32_t x) {
  if (snap == nullptr) return x;
  if (!any) return 1;
  const int32_t s = x >= 0 && x < S ? __ldg(snap + x) : NONE;
  return s != NONE ? s : 0;
}

// ------------------------------------------------------------------ //
// lca*: the join-level walk
// ------------------------------------------------------------------ //

struct Euler {
  const int32_t* first;  // (size,) first occurrence, -1 off the tour
  int size;
  const int32_t* tour;    // (T,)
  const int32_t* depths;  // (T,)
  const int32_t* block_min;  // (nb,)
  int nb;
  const int32_t* sparse;  // (max(nlevels, 1), nb)
  int nlevels;
};

// The lane's candidates for the leftmost minimum of depths[lo..=hi], all
// inside the 64-block at base, as (depth << 32 | position) keys.
template <int G>
__device__ __forceinline__ uint64_t block_scan(const int32_t* depths,
                                               int base, int lo, int hi,
                                               int lane) {
  constexpr int P = kBlock / G;
  uint64_t best = ~0ull;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = base + lane * P + i;
    if (p >= lo && p <= hi) {
      const uint64_t key =
          ((uint64_t)(uint32_t)__ldg(depths + p) << 32) | (uint32_t)p;
      best = key < best ? key : best;
    }
  }
  return best;
}

template <int G>
__device__ __forceinline__ uint64_t group_min(uint64_t v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const uint64_t w = __shfl_xor_sync(mask, v, o, G);
    v = w < v ? w : v;
  }
  return v;
}

template <int G>
__global__ void __launch_bounds__(kLcaGroups * G)
    rmq_lca_kernel(Euler e, const int32_t* __restrict__ utaxa,
                   const uint8_t* __restrict__ uvalid, int B, int K,
                   const int32_t* __restrict__ snap, int S,
                   int32_t* __restrict__ out) {
  const int lane = threadIdx.x % G;
  const long long g = (long long)blockIdx.x * kLcaGroups + threadIdx.x / G;
  if (g >= B) return;
  const int shift = (threadIdx.x & 31) & ~(G - 1);
  const unsigned bits_of = G == 32 ? FULL : (1u << G) - 1;
  const unsigned mask = bits_of << shift;
  const uint8_t* vrow = uvalid + g * K;
  const int32_t* urow = utaxa + g * K;
  bool have = false;
  int32_t cons = 0, cdep = 0, level = -1;
  for (int base = 0; base < K; base += G) {
    const int k = base + lane;
    const bool v = k < K && vrow[k] != 0;
    unsigned bits = (__ballot_sync(mask, v) >> shift) & bits_of;
    if (!bits) continue;
    int32_t occ = 0, docc = 0;
    if (v) {
      occ = max(__ldg(e.first + min(max(urow[k], 0), e.size - 1)), 0);
      docc = __ldg(e.depths + occ);
    }
    while (bits) {
      const int src = __ffs(bits) - 1;
      bits &= bits - 1;
      const int32_t nxt = __shfl_sync(mask, occ, src, G);
      const int32_t dn = __shfl_sync(mask, docc, src, G);
      if (!have) {  // the first valid slot seeds the walk
        have = true;
        cons = nxt;
        cdep = dn;
        continue;
      }
      if (nxt == cons) continue;
      const int left = min(cons, nxt), right = max(cons, nxt);
      const int lblock = left >> 6, rblock = right >> 6;
      const int bdiff = rblock - lblock;
      const int lbase = lblock << 6, rbase = rblock << 6;
      // the middle's candidates (block-min, or the sparse table's two)
      // are loaded first, so that their loads overlap the block scans'
      int32_t t1 = 0, t2 = 0;
      if (bdiff >= 2) {
        const int col = min(max(lblock + 1, 0), e.nb - 1);
        if (bdiff == 2) {
          t1 = __ldg(e.block_min + col);
        } else {
          const int ilog = 31 - __clz(bdiff - 1);
          const int kk = min(max(ilog - 1, 0), max(e.nlevels - 1, 0));
          const int c2 = min(max(rblock - (1 << (kk + 1)), 0), e.nb - 1);
          const int32_t* row = e.sparse + (long long)kk * e.nb;
          t1 = __ldg(row + col);
          t2 = __ldg(row + c2);
        }
      }
      int32_t rmq, drmq;
      if (bdiff == 0) {
        const uint64_t one = group_min<G>(
            block_scan<G>(e.depths, lbase, left, right, lane), mask);
        rmq = (int32_t)(uint32_t)one;
        drmq = (int32_t)(one >> 32);
      } else {
        uint64_t l = block_scan<G>(e.depths, lbase, left, lbase + kBlock - 1,
                                   lane);
        uint64_t r = block_scan<G>(e.depths, rbase, rbase, right, lane);
        int32_t d1 = 0, d2 = 0;
        if (bdiff >= 2) {
          d1 = __ldg(e.depths + t1);
          if (bdiff > 2) d2 = __ldg(e.depths + t2);
        }
        l = group_min<G>(l, mask);
        r = group_min<G>(r, mask);
        const int32_t lp = (int32_t)(uint32_t)l, dl = (int32_t)(l >> 32);
        const int32_t rp = (int32_t)(uint32_t)r, dr = (int32_t)(r >> 32);
        if (bdiff == 1) {
          const bool tl = dl <= dr;
          rmq = tl ? lp : rp;
          drmq = tl ? dl : dr;
        } else {
          // bdiff 2: the block-min entry; past it the sparse pick
          const bool take1 = bdiff == 2 || d1 <= d2;
          const int32_t m = take1 ? t1 : t2, dm = take1 ? d1 : d2;
          const bool le = dl <= dm;
          const int32_t ex = le ? lp : m, dex = le ? dl : dm;
          const bool lr = dex <= dr;
          rmq = lr ? ex : rp;
          drmq = lr ? dex : dr;
        }
      }
      const bool neither = rmq != cons && rmq != nxt;
      int32_t lca = neither ? rmq : rmq == cons ? nxt : cons;
      int32_t dlca = neither ? drmq : rmq == cons ? dn : cdep;
      const int32_t lvl = neither ? drmq : level;
      if (level >= 0 && dlca > level) {  // below the join level: demoted
        lca = rmq;
        dlca = drmq;
      }
      cons = lca;
      cdep = dlca;
      level = lvl;
    }
  }
  if (!have) cons = max(__ldg(e.first), 0);
  if (lane == 0) out[g] = put_snap(snap, S, have, __ldg(e.tour + cons));
}

// ------------------------------------------------------------------ //
// hybrid: the LCA closure, as a warp or a block
// ------------------------------------------------------------------ //

struct Tax {
  const int32_t* geom;  // (size, W) = [depth | lineage of D = W - 1]
  int size, W;
  __device__ __forceinline__ const int32_t* row(int s) const {
    return geom + (long long)s * W + 1;
  }
};

struct Best {
  float s;
  int32_t d, v;
};

// higher score, then deeper, then the smaller id
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.s > b.s || (a.s == b.s && (a.d > b.d || (a.d == b.d && a.v < b.v)));
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best c{__shfl_xor_sync(FULL, b.s, o), __shfl_xor_sync(FULL, b.d, o),
           __shfl_xor_sync(FULL, b.v, o)};
    if (better(c, b)) b = c;
  }
  return b;
}

struct WarpTeam {
  static constexpr int T = 32;
  __device__ int tid() const { return threadIdx.x & 31; }
  __device__ void sync() const { __syncwarp(); }
  // the team's slots valid among base + tid(): the slot's place in the
  // compacted list (when v) and the count, in slot order
  __device__ int place(bool v, int n, int* total) const {
    const unsigned bits = __ballot_sync(FULL, v);
    *total = n + __popc(bits);
    return n + __popc(bits & ((1u << tid()) - 1));
  }
  __device__ Best best(Best b) const { return warp_best(b); }
};

struct BlockTeam {
  static constexpr int T = kMixThreads;
  int* counts;  // kMixThreads / 32 warp totals
  Best* bests;  // kMixThreads / 32 warp bests
  __device__ int tid() const { return threadIdx.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ int place(bool v, int n, int* total) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned bits = __ballot_sync(FULL, v);
    if (lane == 0) counts[warp] = __popc(bits);
    __syncthreads();
    int before = n, all = n;
    for (int w = 0; w < T / 32; ++w) {
      before += w < warp ? counts[w] : 0;
      all += counts[w];
    }
    __syncthreads();  // the totals are read before the next chunk
    *total = all;
    return before + __popc(bits & ((1u << lane) - 1));
  }
  __device__ Best best(Best b) const {
    b = warp_best(b);
    if ((threadIdx.x & 31) == 0) bests[threadIdx.x >> 5] = b;
    __syncthreads();
    b = bests[0];
    for (int w = 1; w < T / 32; ++w)
      if (better(bests[w], b)) b = bests[w];
    __syncthreads();
    return b;
  }
};

// Length of the common prefix of two lineage rows over which they agree
// and are not NONE (the plain version's agreement count on a taxonomy's
// rows, where that prefix runs to the LCA's depth): a binary search.
__device__ __forceinline__ int agree(const int32_t* a, const int32_t* b,
                                     int D) {
  int lo = 0, hi = D;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t x = __ldg(a + mid);
    if (x != NONE && x == __ldg(b + mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Bitonic sort of keys[0..n2) (n2 a power of two) by less(a, b).
template <class Team, class Less>
__device__ void bitonic(const Team& team, int32_t* keys, int n2, Less less) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = team.tid(); i < n2; i += Team::T) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int32_t a = keys[i], b = keys[ixj];
          if ((i & k) == 0 ? less(b, a) : less(a, b)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      team.sync();
    }
  }
}

// hybrid on one group: the aggregate (I32_MAX with no valid slot) and, in
// *n_out, the group's valid slots. Every thread of the team calls it and
// every one gets the result.
template <class Team>
__device__ int32_t mix_group(const Team& team, char* area, int cap,
                             const Tax& t, const int32_t* urow,
                             const float* crow, const uint8_t* vrow, int K,
                             int twoK, float f, int* n_out) {
  int32_t* su = (int32_t*)area;  // ids
  int32_t* sa = su + cap;        // clamped ids
  int32_t* sd = sa + cap;        // clamped depths
  float* sc = (float*)(sd + cap);  // counts
  int32_t* ord = (int32_t*)(sc + cap);
  int32_t* cand = ord + pow2_at_least(cap);
  const int D = t.W - 1;
  // the valid slots, in slot order
  int n = 0;
  for (int base = 0; base < K; base += Team::T) {
    const int k = base + team.tid();
    const bool v = k < K && vrow[k] != 0;
    int total;
    const int at = team.place(v, n, &total);
    if (v) {
      const int32_t u = urow[k];
      const int s = min(max(u, 0), t.size - 1);
      su[at] = u;
      sa[at] = s;
      sd[at] = min(max(__ldg(t.geom + (long long)s * t.W), 0), D - 1);
      sc[at] = crow[k];
    }
    n = total;
  }
  *n_out = n;
  if (n == 0) return I32_MAX;
  // the list in lineage order (-1 pads, last)
  const int n2 = pow2_at_least(n);
  for (int i = team.tid(); i < n2; i += Team::T) ord[i] = i < n ? i : -1;
  team.sync();
  bitonic(team, ord, n2, [&](int32_t a, int32_t b) {
    if (a < 0) return false;
    if (b < 0) return true;
    const int32_t* ra = t.row(sa[a]);
    const int32_t* rb = t.row(sa[b]);
    const int l = agree(ra, rb, D);
    if (l < D) {
      const int32_t x = __ldg(ra + l), y = __ldg(rb + l);
      if (x != y) return x < y;
    }
    return a < b;
  });
  // candidates: the inputs, the self pairs' LCAs, the adjacent pairs' LCAs
  const int m = 3 * n - 1, m2 = pow2_at_least(m);
  for (int i = team.tid(); i < m2; i += Team::T) {
    int32_t v = I32_MAX;
    if (i < n) {
      v = su[i];
    } else if (i < 2 * n) {
      const int32_t* r = t.row(sa[i - n]);
      const int l = agree(r, r, D);
      v = l > 0 ? __ldg(r + l - 1) : 0;
    } else if (i < m) {
      const int32_t* r = t.row(sa[ord[i - 2 * n]]);
      const int l = agree(r, t.row(sa[ord[i - 2 * n + 1]]), D);
      v = l > 0 ? __ldg(r + l - 1) : 0;
    }
    cand[i] = v;
  }
  team.sync();
  bitonic(team, cand, m2, [](int32_t a, int32_t b) { return a < b; });
  // each distinct candidate among the 2K smallest (its rank counted in
  // order, as the plain version keeps them), scored in slot order
  const float omf = __fsub_rn(1.0f, f);
  Best best{-INFINITY, -1, I32_MAX};
  int seen = 0;
  for (int base = 0; base < m2; base += Team::T) {
    const int i = base + team.tid();
    const int32_t v = i < m2 ? cand[i] : I32_MAX;
    // the plain version's run heads: its first compare is against -1
    const bool first = v != I32_MAX && v != (i == 0 ? NONE : cand[i - 1]);
    int total;
    const int rank = team.place(first, seen, &total);
    seen = total;
    if (!first || rank >= twoK) continue;
    const int s = min(max(v, 0), t.size - 1);
    const int32_t* rv = t.row(s);
    const int dv = max(__ldg(rv - 1), 0);
    const int dc = min(dv, D - 1);
    float lw = 0.0f, rw = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float c = sc[j];
      if (__ldg(t.row(sa[j]) + dc) == v) lw = __fadd_rn(lw, c);
      if (__ldg(rv + sd[j]) == su[j]) rw = __fadd_rn(rw, c);
    }
    const Best b{__fadd_rn(__fmul_rn(lw, f), __fmul_rn(rw, omf)), dv, v};
    if (better(b, best)) best = b;
  }
  return team.best(best).v;
}

__global__ void __launch_bounds__(kMixWarps * 32)
    rmq_mix_warp_kernel(Tax t, const int32_t* __restrict__ utaxa,
                        const float* __restrict__ ucounts,
                        const uint8_t* __restrict__ uvalid, int B, int K,
                        float f, const int32_t* __restrict__ snap, int S,
                        int32_t* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kMixWarps + warp;
  if (g >= B) return;
  int n;
  const int32_t x = mix_group(WarpTeam{}, smem + warp * mix_area_bytes(kWarpK),
                              kWarpK, t, utaxa + g * K, ucounts + g * K,
                              uvalid + g * K, K, 2 * K, f, &n);
  if ((threadIdx.x & 31) == 0) out[g] = put_snap(snap, S, n > 0, x);
}

__global__ void __launch_bounds__(kMixThreads)
    rmq_mix_block_kernel(Tax t, const int32_t* __restrict__ utaxa,
                         const float* __restrict__ ucounts,
                         const uint8_t* __restrict__ uvalid, int B, int K,
                         float f, const int32_t* __restrict__ snap, int S,
                         int32_t* __restrict__ out, char* scratch) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int counts[kMixThreads / 32];
  __shared__ Best bests[kMixThreads / 32];
  char* area =
      scratch ? scratch + (long long)blockIdx.x * mix_area_bytes(K) : smem;
  const BlockTeam team{counts, bests};
  for (long long g = blockIdx.x; g < B; g += gridDim.x) {
    int n;
    const int32_t x = mix_group(team, area, K, t, utaxa + g * K,
                                ucounts + g * K, uvalid + g * K, K, 2 * K, f,
                                &n);
    if (threadIdx.x == 0) out[g] = put_snap(snap, S, n > 0, x);
    __syncthreads();  // the area is the next group's
  }
}

int launch_lca(const Euler& e, const int32_t* utaxa, const uint8_t* uvalid,
               int B, int K, const int32_t* snap, int S, int32_t* out,
               cudaStream_t stream) {
  const int blocks = (int)(((long long)B + kLcaGroups - 1) / kLcaGroups);
  rmq_lca_kernel<kLcaLanes><<<blocks, kLcaGroups * kLcaLanes, 0, stream>>>(
      e, utaxa, uvalid, B, K, snap, S, out);
  return (int)cudaGetLastError();
}

int launch_mix(const Tax& t, const int32_t* utaxa, const float* ucounts,
               const uint8_t* uvalid, int B, int K, float f,
               const int32_t* snap, int S, char* scratch, int scratch_blocks,
               int32_t* out, cudaStream_t stream) {
  if (K <= kWarpK) {
    const int blocks = (int)(((long long)B + kMixWarps - 1) / kMixWarps);
    rmq_mix_warp_kernel<<<blocks, kMixWarps * 32,
                          kMixWarps * mix_area_bytes(kWarpK), stream>>>(
        t, utaxa, ucounts, uvalid, B, K, f, snap, S, out);
    return (int)cudaGetLastError();
  }
  size_t smem = mix_area_bytes(K);
  int grid = B < kMixGrid ? B : kMixGrid;
  if (smem <= kSmemMax) {
    scratch = nullptr;
  } else if (scratch == nullptr || scratch_blocks < 1) {
    return (int)cudaErrorInvalidValue;  // the lists need the scratch
  } else {
    smem = 0;
    if (scratch_blocks < grid) grid = scratch_blocks;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmq_mix_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rmq_mix_block_kernel<<<grid, kMixThreads, smem, stream>>>(
      t, utaxa, ucounts, uvalid, B, K, f, snap, S, out, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strategy: 0 hybrid, 1 lca*. utaxa (B, K) int32, ucounts (B, K) float32
// (hybrid; null for lca*), uvalid (B, K) bool, all contiguous, K >= 1.
// lca*: the DeviceEuler's first (size,), tour and depths (T,), block_min
// (nb,) and sparse (max(nlevels, 1), nb), int32. hybrid: dtax.geom, size
// rows of W = 1 + D int32, and factor. snap: null (the aggregate is
// written) or the snap table (S int32). scratch: hybrid past K = 64 when
// mix_area_bytes(K) > kSmemMax, scratch_blocks areas of it (the launch
// then runs at most that many blocks); else null. out (B,) int32.
extern "C" int rmq_aggregate(int strategy, const void* utaxa,
                             const void* ucounts, const void* uvalid, int B,
                             int K, const void* first, int size,
                             const void* tour, const void* depths,
                             const void* block_min, int nb,
                             const void* sparse, int nlevels,
                             const void* geom, int geom_size, int W,
                             float factor, const void* snap, int S,
                             void* scratch, int scratch_blocks, void* out,
                             void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || (snap != nullptr && S <= 0)) return (int)cudaErrorInvalidValue;
  const int32_t* u = (const int32_t*)utaxa;
  const uint8_t* v = (const uint8_t*)uvalid;
  const int32_t* sn = (const int32_t*)snap;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (strategy == kLca) {
    if (size <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
    const Euler e{(const int32_t*)first, size, (const int32_t*)tour,
                  (const int32_t*)depths, (const int32_t*)block_min, nb,
                  (const int32_t*)sparse, nlevels};
    return launch_lca(e, u, v, B, K, sn, S, o, s);
  }
  if (strategy != kHybrid || geom_size <= 0 || W < 2 || ucounts == nullptr)
    return (int)cudaErrorInvalidValue;
  const Tax t{(const int32_t*)geom, geom_size, W};
  return launch_mix(t, u, (const float*)ucounts, v, B, K, factor, sn, S,
                    (char*)scratch, scratch_blocks, o, s);
}

extern "C" int rmq_aggregate_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return rmq_aggregate(
      (int)a.i(0), a.ptr(1), a.ptr(2), a.ptr(3), (int)a.i(4), (int)a.i(5),
      a.ptr(6), (int)a.i(7), a.ptr(8), a.ptr(9), a.ptr(10), (int)a.i(11),
      a.ptr(12), (int)a.i(13), a.ptr(14), (int)a.i(15), (int)a.i(16),
      (float)a.d(17), a.ptr(18), (int)a.i(19), a.ptr(20), (int)a.i(21),
      a.ptr(22), a.ptr(23));
}
