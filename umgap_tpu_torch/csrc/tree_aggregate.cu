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
// Counts are summed in float32; exact for the path's integer counts
// (below 2^24), so the order of the plain version's sums does not matter.
//
// What bounds it. Per group the work needs the valid mask (K bytes), the
// id and count of each valid slot and one lineage row per distinct valid
// id, and writes 4 bytes. At the bench's 1-3 valid slots of K = 64 that
// is about 100 bytes a group: 0.5-0.8 us for 16,384 groups at 3.35 TB/s,
// below what one launch of that many groups takes, so the kernel is held
// to a measured floor (the same launch on groups with no valid slot)
// beside its bound. The old kernel staged every group's whole K x D tile
// and ran one warp a group through every depth at the cost of a branch
// point.
//
// Design. A block owns 32 consecutive groups. Its first warp walks them
// a thread a group (the thread path): the thread scans its group's valid
// mask with 16-byte loads, keeps the slots in a per-thread list in shared
// memory ([entry][lane], so lanes at the same entry hit distinct banks),
// loads their ids and counts once, and walks its group alone, reading
// lineage entries of the listed rows only (L1/L2; at most a few hundred
// bytes a group). All blocks of a 16,384-group batch are resident at
// once, so a batch takes as long as its slowest walk: hybrid's walk of up
// to kSmall = 4 slots (the bench's groups) keeps the rows' pointers and
// two lineage columns in registers and loads the next column a step
// ahead (hybrid_small), which took the bench batch from 0.023 to 0.008
// ms, where reading the list and loading a column per slot and step had
// paid a load's latency at each of 25 steps. A group with more than
// kThreadCap = 16 valid slots is left to the warp path: after a block
// barrier the block's kBlockWarps warps deal its such groups out in turn;
// a warp compacts a group's valid slots with ballots into a shared list
// (ids, counts, depths) and runs the same algorithms with lanes over the
// list and warp reductions, the ancestry tests eight independent loads at
// a time. So a group's work follows its valid slots, not K, the wide
// program's K = 408 / 648 costs only the longer mask scan, and a batch of
// full groups keeps four groups a warp (the other warps of a block wait
// at the barrier while the first walks). The sizes come from sweeps on
// an H100 (chip_smoke.py sweep_constant, PERF.md): a thread path limit
// of 4 or 16 gave the bench batch the same time within 5% (0 or 2, which
// send its groups to the warp path, 1.8-5x as long); of 4, 8 and 16 warps
// a block, 4 took 1.2-1.5x as long as 8 on batches of 17-64 and
// of 64 valid hits a group (but for mrtl's full groups, 0.85x), 16 the
// same as 8 there but 1.8x as long on the bench batch.
//
// Wide lists. A warp's list takes 20 bytes a slot, so one warp's list of
// K > 11,571 slots no longer fits a block's shared memory; the wide
// program reaches K = 16,392 (paired reads of 4,096 bp). There the warps'
// lists live in a global scratch that the caller allocates, one list a
// (block, warp), and the block keeps kBlockWarps warps; the thread path
// stays in shared memory. The list is written and read by its own warp
// only, between __syncwarp barriers (which order global memory among the
// warp's lanes as they do shared memory), so the algorithms and their
// slot order are unchanged. After each descent, hybrid's warp walk keeps
// only the slots under the new node in its list, so a depth step costs
// the square of that subtree's slots, not of the group's.

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
template <int STRAT>
__device__ void warp_group(const Rows& src, long long b,
                           const float* __restrict__ counts,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ utaxa, int K,
                           int root, float factor, unsigned char* base,
                           int32_t* __restrict__ out) {
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
  __syncwarp();
  for (int p = lane; p < n; p += 32) {
    const int k = Lk[p];
    const int u = utaxa[b * K + k];
    Lu[p] = u;
    Lc[p] = STRAT != kLca ? counts[b * K + k] : 0.0f;
    Ld[p] = STRAT != kHybrid ? src.depth(u) : 0;
  }
  __syncwarp();

  if (STRAT == kHybrid) {
    float part = 0.0f;
    for (int p = lane; p < n; p += 32) part += Lc[p];
    float a_base = warp_sum_f(part);
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
    if (lane == 0) out[b] = x;
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
    if (lane == 0) out[b] = bu;
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
    if (lane == 0) out[b] = Lu[pstar];
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
  if (lane == 0) out[b] = ref[dstar];
}

template <int STRAT>
__global__ void tree_kernel(Rows src, const float* __restrict__ counts,
                            const uint8_t* __restrict__ valid,
                            const int32_t* __restrict__ utaxa, int B, int K,
                            int root, float factor,
                            unsigned char* __restrict__ scratch,
                            int32_t* __restrict__ out) {
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
        out[b] = STRAT == kHybrid && n <= kSmall
                     ? hybrid_small(src, n, tu, tc, root, factor)
                     : thread_group<STRAT>(src, n, tu, tc, td, root, factor);
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
    warp_group<STRAT>(src, b0 + t, counts, valid, utaxa, K, root, factor,
                      base, out);
    __syncwarp();
  }
}

template <int STRAT>
int launch(const Rows& src, const float* counts, const uint8_t* valid,
           const int32_t* utaxa, int B, int K, int root, float factor,
           unsigned char* scratch, int32_t* out, cudaStream_t stream) {
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
        tree_kernel<STRAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)(((long long)B + 31) / 32);
  tree_kernel<STRAT><<<blocks, 32 * warps, smem, stream>>>(
      src, counts, valid, utaxa, B, K, root, factor, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strategy: 0 hybrid, 1 lca* (counts unused, may be null), 2 mrtl.
// geom: dtax.geom, size rows of W = 1 + D int32, contiguous. valid (B, K)
// bool, utaxa (B, K) int32, counts (B, K) float32, all contiguous; out
// (B,) int32. scratch: null while one warp's list of K slots fits the
// block's shared memory (list_bytes(K) <= kSmemMax), else
// ceil(B / 32) * kBlockWarps * list_bytes(K) bytes, 16-byte aligned
// (agg/device.py tree_scratch_bytes).
extern "C" int tree_aggregate(int strategy, const void* geom, int size,
                              int W, const void* counts, const void* valid,
                              const void* utaxa, int B, int K, int root,
                              float factor, void* scratch, void* out,
                              void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || W < 2 || size <= 0) return (int)cudaErrorInvalidValue;
  const Rows src{(const int32_t*)geom, size, W, W - 1};
  const float* c = (const float*)counts;
  const uint8_t* v = (const uint8_t*)valid;
  const int32_t* u = (const int32_t*)utaxa;
  unsigned char* sc = (unsigned char*)scratch;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (strategy) {
    case kHybrid:
      return launch<kHybrid>(src, c, v, u, B, K, root, factor, sc, o, s);
    case kLca:
      return launch<kLca>(src, c, v, u, B, K, root, factor, sc, o, s);
    case kMrtl:
      return launch<kMrtl>(src, c, v, u, B, K, root, factor, sc, o, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tree_aggregate_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return tree_aggregate((int)a.i(0), a.ptr(1), (int)a.i(2), (int)a.i(3),
                        a.ptr(4), a.ptr(5), a.ptr(6), (int)a.i(7),
                        (int)a.i(8), (int)a.i(9), (float)a.d(10), a.ptr(11),
                        a.ptr(12), a.ptr(13));
}
