// K5 lane_gather: a gather from an int32 tile, along its rows or its
// lanes, with an index tensor of any strides; and its ancestry epilogue,
// lane_gather_ancestry, which writes hit_geometry's bool incidence
// directly.
//
// Replaces the eight in-VMEM gather Pallas kernels of the TPU
// experiments, which all compute one primitive on (S, 128) int32 tiles:
//   scripts/exp_pallas_dma.py:171 dyngather_case (take_along_axis,
//     axis 0, one row index broadcast over the lanes),
//   scripts/exp_pallas_gather.py:47 k1 (1-D jnp.take), :62 k2 and :77 k3
//     (take_along_axis axis 0, fewer index rows than table rows; k3's
//     `idx >> 7` is applied by the caller),
//   scripts/exp_dyngather.py:37 make (take_along_axis on axis 0 or 1),
//   scripts/exp_probe_primitives.py:66 f3 and :96 f4 (axis 0, f4 over a
//     grid of 64 tiles: the group dimension G here),
//   scripts/exp_probe2.py:75, :87, :112 (axis 0).
// No path of the port launches it since K9 (csrc/rmq_aggregate.cu) took
// the Euler/RMQ aggregators' table reads; it serves hit_geometry, the
// 1-D take of snap_batch and rmq_*_batch called alone on the card. The
// epilogue
// replaces hit_geometry's one-hot MXU contraction and compare
// (umgap_tpu/agg/device.py:170, the einsum at :191, the masks at :194):
//   is_anc[b, i, j] = (lin[b, j, dep[b, i]] == utaxa[b, i])
//                     & valid[b, i] & valid[b, j],
// one byte per element, with no int32 (B, K, K) intermediate.
//
// Modes of lane_gather (out is contiguous; tab and idx are read through
// their strides, so an expanded index costs no memory):
//   rows  (axis -2): out[g, i, l] = tab[g, idx[g, i, l], l]
//                    tab (G, S, W), idx (G, I, W), out (G, I, W);
//                    the 1-D take is this mode with G = W = 1.
//   lanes (axis -1): out[g, i, j] = tab[g, i, idx[g, i, j]]
//                    tab (G, I, W), idx (G, I, J), out (G, I, J).
// Indices must lie in range; callers clamp them (as the JAX code does).
//
// Bound on the H100: bytes. The least traffic is the part of the tile
// the gather reads (at most the whole tile, read once), the index
// tensor as stored (an expanded index is read once per distinct
// element) and the output, written once. The epilogue needs the lineage
// elements of valid (j, dep[i]) pairs, dep, utaxa and valid, and writes
// B * K * K bytes: at the main shape (16,384 groups, K = 64) the 67 MB
// output is nearly all of it.
//
// Design (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's kernels and
// gather phases):
//  - rows mode, staged: when a group's whole tile fits the staging limit
//    (96 KB of shared memory) and there are groups enough to fill the
//    SMs, one block per group copies its tile into shared memory in the
//    tile's memory order with 16-byte loads (a compact tile: one stride
//    1, the other a pitch P; 32-bit offsets, one division per 16 bytes),
//    into rows of an odd pitch so a warp's reads spread over the banks;
//    after one barrier every output reads shared memory, and each thread
//    writes 4 int32 as one 16-byte store (W = 64 is a template
//    constant). Every staged word must be read at least once on average
//    (I >= S). The sweep over 1,024 tiles of (S, 128) found staging
//    1.4-1.8x faster than the direct read from 8 KB to 96 KB, so the
//    limit is 96 KB (it was 48 KB on one point each side); at the old
//    main shape, 16,384 transposed (26, 64) lineage tiles, it takes
//    0.140 ms of device time against 0.197 before the redesign.
//  - rows mode, one row index per output row (an index expanded over the
//    lanes, the taxonomy row gather): a thread per 4 consecutive outputs
//    of the flat output, one 16-byte store each, the row index read once
//    per row.
//  - rows and lanes modes, direct: threads grid-strided over the
//    outputs read their index and tile element through L1/L2 (50 MB of
//    L2 holds every table of the port's path); consecutive threads write
//    consecutive outputs. Single big tables, few index rows, the 1-D
//    takes.
//  - the epilogue writes 16 bools a thread as one 16-byte store (a
//    16-byte load of valid[b, j0 .. j0 + 15] when K % 16 == 0, K = 64 a
//    template constant) and reads a lineage element only for a valid
//    (i, j) pair, through L1/L2: a group holds a few valid slots of K,
//    so the kernel is little more than its output. A staged variant (the
//    lineage tile's needed chunks in shared memory) measured 0.045 ms
//    against 0.037 for this direct one at K = 64, 0.153 against 0.132 at
//    K = 408 and 0.518 against 0.315 at K = 648, and went.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 256;

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// The most dynamic shared memory a block may opt in to.
long long max_smem() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      n = 48 * 1024;
  }
  return n;
}

int grid_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  const long long cap = 32LL * sm_count();
  return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

// Raises a kernel's dynamic shared memory limit past the default 48 KB
// the first time a launch needs it.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024 || smem <= *granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *granted = smem;
  return e;
}

// A compact 2-D tile: element (a, b), a the major index and b the minor,
// lies at base[a * P + b] (P >= n_minor); it is staged at sm[a * Q + b].
// The tile's span is read in memory order as 16-byte chunks from the
// aligned address at or below base (a chunk never crosses the 16-byte
// granule that holds a word of the tile).
__device__ void stage_tile(int32_t* __restrict__ sm,
                           const int32_t* __restrict__ base, int n_major,
                           int n_minor, int P, int Q) {
  const uintptr_t a0 = (uintptr_t)base & ~(uintptr_t)15;
  const int lead = (int)(((uintptr_t)base - a0) >> 2);
  const int span = (n_major - 1) * P + n_minor;
  const int chunks = (lead + span + 3) >> 2;
  const int4* src = reinterpret_cast<const int4*>(a0);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int o0 = c * 4 - lead;  // offset of the chunk's first word
    const int f = o0 > 0 ? o0 : 0;
    int a = f / P;
    int b = f - a * P;
    const int4 v = __ldg(src + c);
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = o0 + k;
      if (o < 0) continue;
      if (o >= span) break;
      if (b < n_minor) sm[a * Q + b] = w[k];
      if (++b == P) {
        b = 0;
        ++a;
      }
    }
  }
}

__host__ __device__ inline int odd_pitch(int n) { return n | 1; }

// ---------------------------------------------------------------------- //
// rows mode
// ---------------------------------------------------------------------- //

// Staged rows mode: tab is compact with lanes minor (ts2 == 1, pitch
// ts1) or rows minor (ts1 == 1, pitch ts2). WT: W as a template
// constant (0 = runtime). W % 4 == 0 and out 16-byte aligned.
template <int WT>
__global__ void rows_staged(const int32_t* __restrict__ tab, int S, int W_,
                            long long ts0, int P, bool lanes_minor,
                            const int32_t* __restrict__ idx, int I,
                            long long is0, long long is1, long long is2,
                            int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];
  const int W = WT ? WT : W_;
  const long long g = blockIdx.x;
  int Q, qs, ql;
  if (lanes_minor) {
    Q = odd_pitch(W);
    qs = Q;
    ql = 1;
    stage_tile(tile, tab + g * ts0, S, W, P, Q);
  } else {
    Q = odd_pitch(S);
    qs = 1;
    ql = Q;
    stage_tile(tile, tab + g * ts0, W, S, P, Q);
  }
  __syncthreads();
  const int32_t* ig = idx + g * is0;
  int4* og = reinterpret_cast<int4*>(out + g * (long long)I * W);
  const int W4 = W >> 2;
  const int n = I * W4;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int i = q / W4;
    const int l = (q - i * W4) << 2;
    const int32_t* ip = ig + i * is1 + l * is2;
    int r[4];
    r[0] = ip[0];
    if (is2 == 0) {
      r[1] = r[2] = r[3] = r[0];
    } else {
      r[1] = ip[is2];
      r[2] = ip[2 * is2];
      r[3] = ip[3 * is2];
    }
    og[q] = make_int4(tile[r[0] * qs + l * ql], tile[r[1] * qs + (l + 1) * ql],
                      tile[r[2] * qs + (l + 2) * ql],
                      tile[r[3] * qs + (l + 3) * ql]);
  }
}

template <typename T>
__global__ void rows_global(const int32_t* __restrict__ tab, T W,
                            long long ts0, long long ts1, long long ts2,
                            const int32_t* __restrict__ idx, T I,
                            long long is0, long long is1, long long is2,
                            int32_t* __restrict__ out, T n) {
  const T step = (T)gridDim.x * blockDim.x;
  for (T e = (T)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += step) {
    const T l = e % W, t = e / W;
    const T i = t % I, g = t / I;
    const T r = idx[g * is0 + i * is1 + l * is2];
    out[e] = __ldg(tab + g * ts0 + r * ts1 + l * ts2);
  }
}

// Rows mode with one row index per output row (lane stride 0): each
// thread writes 4 consecutive outputs of the flat (G * I, W) output as
// one 16-byte store, walking across row ends, with one division per 4
// outputs (none for G == 1 beyond it) and the row's index read once per
// row it touches.
template <typename T>
__global__ void rows_bcast(const int32_t* __restrict__ tab, T W,
                           long long ts0, long long ts1, long long ts2,
                           const int32_t* __restrict__ idx, T I,
                           long long is0, long long is1,
                           int32_t* __restrict__ out, T n) {
  const T chunks = (n + 3) >> 2;
  const T step = (T)gridDim.x * blockDim.x;
  const bool one = n == I * W;  // G == 1
  for (T c = (T)blockIdx.x * blockDim.x + threadIdx.x; c < chunks;
       c += step) {
    const T e = c << 2;
    T row = e / W;
    T l = e - row * W;
    T g = one ? 0 : row / I;
    const int32_t* src = tab + g * ts0 +
                         (long long)idx[g * is0 + (row - g * I) * is1] * ts1;
    int v[4] = {0, 0, 0, 0};
    const int m = n - e < 4 ? (int)(n - e) : 4;
    for (int k = 0; k < m; ++k) {
      v[k] = __ldg(src + l * ts2);
      if (++l == W && k + 1 < m) {
        l = 0;
        ++row;
        g = one ? 0 : row / I;
        src = tab + g * ts0 +
              (long long)idx[g * is0 + (row - g * I) * is1] * ts1;
      }
    }
    if (m == 4) {
      reinterpret_cast<int4*>(out)[c] = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < m; ++k) out[e + k] = v[k];
    }
  }
}

template <typename T>
__global__ void lanes_global(const int32_t* __restrict__ tab, long long ts0,
                             long long ts1, long long ts2,
                             const int32_t* __restrict__ idx, T I, T J,
                             long long is0, long long is1, long long is2,
                             int32_t* __restrict__ out, T n) {
  const T step = (T)gridDim.x * blockDim.x;
  for (T e = (T)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += step) {
    const T j = e % J, t = e / J;
    const T i = t % I, g = t / I;
    const T c = idx[g * is0 + i * is1 + j * is2];
    out[e] = __ldg(tab + g * ts0 + i * ts1 + c * ts2);
  }
}

// The staged rows mode's plan: the pitch of a compact tile, or 0 when
// the tile is not compact (then the direct path reads it).
long long compact_pitch(long long n_major, long long n_minor,
                        long long minor_stride, long long pitch) {
  if (minor_stride != 1 || pitch < n_minor || pitch >= (1LL << 20))
    return 0;
  // the tile is read whole: it must be most of its span
  if ((n_major - 1) * pitch + n_minor > 2 * n_major * n_minor) return 0;
  return pitch;
}

// ---------------------------------------------------------------------- //
// the ancestry epilogue
// ---------------------------------------------------------------------- //

// Direct, K % 16 == 0: a thread per 16 outputs of one row i; valid[b, j0
// .. j0 + 15] is one 16-byte load.
template <typename T, int KT>
__global__ void anc_direct16(const int32_t* __restrict__ lin, T K_,
                             long long ls0, long long lsj, long long lsd,
                             const int32_t* __restrict__ dep,
                             const int32_t* __restrict__ uta,
                             const uint8_t* __restrict__ valid,
                             uint8_t* __restrict__ out, T n) {
  const T K = KT ? (T)KT : K_;
  const T R = K >> 4;
  const T step = (T)gridDim.x * blockDim.x;
  for (T q = (T)blockIdx.x * blockDim.x + threadIdx.x; q < n; q += step) {
    const T t = q / R;  // b * K + i
    const T j0 = (q - t * R) << 4;
    const T b = t / K;
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    if (valid[t]) {
      const uint4 vv = __ldg(reinterpret_cast<const uint4*>(
          valid + b * K + j0));
      const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
      const int32_t* col = lin + b * ls0 + (long long)dep[t] * lsd;
      const int32_t u = uta[t];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        if ((vw[jj >> 2] >> ((jj & 3) << 3)) & 0xFF) {
          if (__ldg(col + (j0 + jj) * lsj) == u)
            wd[jj >> 2] |= 1u << ((jj & 3) << 3);
        }
      }
    }
    reinterpret_cast<uint4*>(out)[q] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// Direct, any K: a thread per 16 consecutive bytes of the flat output,
// walking (b, i, j) across row ends.
template <typename T>
__global__ void anc_direct(const int32_t* __restrict__ lin, T K,
                           long long ls0, long long lsj, long long lsd,
                           const int32_t* __restrict__ dep,
                           const int32_t* __restrict__ uta,
                           const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ out, T total) {
  const T n = (total + 15) >> 4;
  const T step = (T)gridDim.x * blockDim.x;
  for (T q = (T)blockIdx.x * blockDim.x + threadIdx.x; q < n; q += step) {
    const T e = q << 4;
    T t = e / K;  // b * K + i
    T j = e - t * K;
    T b = t / K;
    const int m = total - e < 16 ? (int)(total - e) : 16;
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    bool vi = valid[t];
    const int32_t* col = lin + b * ls0 + (long long)dep[t] * lsd;
    int32_t u = uta[t];
    for (int jj = 0; jj < m; ++jj) {
      if (vi && valid[b * K + j] && __ldg(col + j * lsj) == u)
        wd[jj >> 2] |= 1u << ((jj & 3) << 3);
      if (++j == K && jj + 1 < m) {
        j = 0;
        ++t;
        b = t / K;
        vi = valid[t];
        col = lin + b * ls0 + (long long)dep[t] * lsd;
        u = uta[t];
      }
    }
    if (m == 16) {
      reinterpret_cast<uint4*>(out)[q] =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    } else {
      for (int jj = 0; jj < m; ++jj)
        out[e + jj] = (uint8_t)(wd[jj >> 2] >> ((jj & 3) << 3));
    }
  }
}

size_t rows_granted = 0, rows64_granted = 0;

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// axis -2 (rows): tab (G, S, W), idx (G, I, J = W), out (G, I, W).
// axis -1 (lanes): tab (G, I, W), idx (G, I, J), out (G, I, J).
// Strides are in elements; out is contiguous. Whole tiles of at most
// stage_bytes of shared memory may be staged.
extern "C" int lane_gather(int axis, const void* tab, long long G,
                           long long S, long long W, long long ts0,
                           long long ts1, long long ts2, const void* idx,
                           long long I, long long J, long long is0,
                           long long is1, long long is2, void* out,
                           long long stage_bytes, void* stream) {
  const long long n = G * I * J;
  if (n <= 0) return 0;
  const int32_t* t = (const int32_t*)tab;
  const int32_t* x = (const int32_t*)idx;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  // 32-bit loop counters when the output's element count leaves room for
  // a grid stride (memory offsets through the strides are 64-bit either
  // way)
  const bool small = n < (1LL << 30);
  if (axis == -2 && W % 4 == 0 && I >= S && G >= sm_count() && small &&
      ((uintptr_t)o & 15) == 0) {
    const bool lanes_minor = ts2 == 1;
    const long long P = lanes_minor ? compact_pitch(S, W, ts2, ts1)
                                    : compact_pitch(W, S, ts1, ts2);
    const long long smem =
        4 * (lanes_minor ? S * odd_pitch((int)W) : W * odd_pitch((int)S));
    if (P > 0 && smem <= stage_bytes && smem <= max_smem()) {
      cudaError_t e;
      if (W == 64) {
        e = allow_smem(rows_staged<64>, (size_t)smem, &rows64_granted);
        if (e != cudaSuccess) return (int)e;
        rows_staged<64><<<(unsigned)G, kThreads, (size_t)smem, s>>>(
            t, (int)S, (int)W, ts0, (int)P, lanes_minor, x, (int)I, is0,
            is1, is2, o);
      } else {
        e = allow_smem(rows_staged<0>, (size_t)smem, &rows_granted);
        if (e != cudaSuccess) return (int)e;
        rows_staged<0><<<(unsigned)G, kThreads, (size_t)smem, s>>>(
            t, (int)S, (int)W, ts0, (int)P, lanes_minor, x, (int)I, is0,
            is1, is2, o);
      }
      return (int)cudaGetLastError();
    }
  }
  if (axis == -2 && is2 == 0 && W > 1 && ((uintptr_t)o & 15) == 0) {
    if (small) {
      rows_bcast<int><<<grid_for((n + 3) / 4, kThreads), kThreads, 0, s>>>(
          t, (int)W, ts0, ts1, ts2, x, (int)I, is0, is1, o, (int)n);
    } else {
      rows_bcast<long long><<<grid_for((n + 3) / 4, kThreads), kThreads, 0,
                              s>>>(t, W, ts0, ts1, ts2, x, I, is0, is1, o,
                                   n);
    }
  } else if (axis == -2 && small) {
    rows_global<int><<<grid_for(n, kThreads), kThreads, 0, s>>>(
        t, (int)W, ts0, ts1, ts2, x, (int)I, is0, is1, is2, o, (int)n);
  } else if (axis == -2) {
    rows_global<long long><<<grid_for(n, kThreads), kThreads, 0, s>>>(
        t, W, ts0, ts1, ts2, x, I, is0, is1, is2, o, n);
  } else if (small) {
    lanes_global<int><<<grid_for(n, kThreads), kThreads, 0, s>>>(
        t, ts0, ts1, ts2, x, (int)I, (int)J, is0, is1, is2, o, (int)n);
  } else {
    lanes_global<long long><<<grid_for(n, kThreads), kThreads, 0, s>>>(
        t, ts0, ts1, ts2, x, I, J, is0, is1, is2, o, n);
  }
  return (int)cudaGetLastError();
}

// lin (B, K, D) int32 with strides (ls0, lsj, lsd); dep, utaxa (B, K)
// int32 and valid (B, K) bytes, contiguous; out (B, K, K) bytes,
// contiguous and 16-byte aligned. dep[b, i] must lie in [0, D) where
// valid[b, i].
extern "C" int lane_gather_ancestry(const void* lin, long long B,
                                    long long K, long long ls0,
                                    long long lsj, long long lsd,
                                    const void* dep, const void* utaxa,
                                    const void* valid, void* out,
                                    void* stream) {
  const long long total = B * K * K;
  if (total <= 0) return 0;
  const int32_t* l = (const int32_t*)lin;
  const int32_t* dp = (const int32_t*)dep;
  const int32_t* u = (const int32_t*)utaxa;
  const uint8_t* v = (const uint8_t*)valid;
  uint8_t* o = (uint8_t*)out;
  if (((uintptr_t)o & 15) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = total < (1LL << 31) - 16;
  const bool k16 = K % 16 == 0 && ((uintptr_t)v & 15) == 0;
  if (k16) {
    const long long n = total / 16;
    if (K == 64 && small) {
      anc_direct16<int, 64><<<grid_for(n, kThreads), kThreads, 0, s>>>(
          l, 64, ls0, lsj, lsd, dp, u, v, o, (int)n);
    } else if (small) {
      anc_direct16<int, 0><<<grid_for(n, kThreads), kThreads, 0, s>>>(
          l, (int)K, ls0, lsj, lsd, dp, u, v, o, (int)n);
    } else {
      anc_direct16<long long, 0><<<grid_for(n, kThreads), kThreads, 0, s>>>(
          l, K, ls0, lsj, lsd, dp, u, v, o, n);
    }
  } else if (small) {
    anc_direct<int><<<grid_for((total + 15) / 16, kThreads), kThreads, 0,
                      s>>>(l, (int)K, ls0, lsj, lsd, dp, u, v, o,
                           (int)total);
  } else {
    anc_direct<long long><<<grid_for((total + 15) / 16, kThreads), kThreads,
                            0, s>>>(l, K, ls0, lsj, lsd, dp, u, v, o, total);
  }
  return (int)cudaGetLastError();
}

extern "C" int lane_gather_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return lane_gather((int)a.i(0), a.ptr(1), a.i(2), a.i(3), a.i(4), a.i(5),
                     a.i(6), a.i(7), a.ptr(8), a.i(9), a.i(10), a.i(11),
                     a.i(12), a.i(13), a.ptr(14), a.i(15), a.ptr(16));
}

extern "C" int lane_gather_ancestry_packed(const void* args) {
  const PackedArgs a{(const unsigned char*)args};
  return lane_gather_ancestry(a.ptr(0), a.i(1), a.i(2), a.i(3), a.i(4), a.i(5),
                              a.ptr(6), a.ptr(7), a.ptr(8), a.ptr(9),
                              a.ptr(10));
}
