// K5 lane_gather: a gather from an int32 tile, along its rows or its
// lanes, with an index tensor of any strides.
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
// On the port's path it is the ancestry gather of hit_geometry
// (a[b, i, j] = lin[b, j, dep[b, i]], the JAX package's one-hot MXU
// contraction, umgap_tpu/agg/device.py:178-193), the row gathers of the
// taxonomy tables, the 1-D takes of snap_batch and of the Euler/RMQ
// tables, and the two contractions of rmq_mix_batch.
//
// Modes (out is contiguous; tab and idx are read through their strides,
// so an expanded index costs no memory):
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
// element) and the output, written once.
//
// Design. Two paths in rows mode, chosen from the shapes:
//  - staged: one block per group g copies the whole (S, W) tile into
//    shared memory once, walking it in its memory order, then every
//    output reads shared memory; when W is a multiple of 32 (the main
//    path's K = 64) a warp's 32 lanes fall on 32 distinct banks whatever
//    rows they pick, so the gather is free of bank conflicts. Taken when the tile fits in kStageBytes (the
//    default 48 KB, no opt-in), every staged word is read at least once
//    on average (I >= S) and there are groups enough to fill the SMs.
//    This is the main path's ancestry gather: 16,384 transposed (26, 64)
//    lineage tiles, whose strided lanes a direct read would fetch a
//    sector per element. There it takes 0.206 ms of device time against
//    0.327 ms for the direct path (NVIDIA H100 80GB HBM3, 700 W).
//  - direct: one thread per output element, grid-strided, reading its
//    index and its tile element through L1/L2 (50 MB of L2 holds every
//    table of the port's path); consecutive threads write consecutive
//    outputs. Everything else: a single big table, few index rows, the
//    1-D takes, tiles above 48 KB. Staging 64 tiles of (512, 128) in
//    32-lane chunks took 0.064 ms against 0.036-0.038 ms direct on the
//    same card, so tiles that do not fit whole are not staged.
// Lanes mode reads through L1/L2 too: a row is read by the threads that
// write the row's outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kStageBytes = 48 * 1024;

template <typename T>
__global__ void rows_staged(const int32_t* __restrict__ tab, T S, T W,
                            long long ts0, long long ts1, long long ts2,
                            const int32_t* __restrict__ idx, T I,
                            long long is0, long long is1, long long is2,
                            int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // S x W
  const T g = blockIdx.x;
  const int32_t* tg = tab + g * ts0;
  const T n = S * W;
  if (ts1 <= ts2) {  // rows adjacent in memory: walk s fastest
    for (T e = threadIdx.x; e < n; e += blockDim.x) {
      const T s = e % S, l = e / S;
      tile[s * W + l] = tg[s * ts1 + l * ts2];
    }
  } else {
    for (T e = threadIdx.x; e < n; e += blockDim.x) {
      const T s = e / W, l = e % W;
      tile[s * W + l] = tg[s * ts1 + l * ts2];
    }
  }
  __syncthreads();
  const int32_t* ig = idx + g * is0;
  int32_t* og = out + g * I * W;
  const T m = I * W;
  for (T e = threadIdx.x; e < m; e += blockDim.x) {
    const T i = e / W, l = e % W;
    og[e] = tile[ig[i * is1 + l * is2] * W + l];
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

int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 32LL * sm_count();
  return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

}  // namespace

extern "C" const char* umgap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// axis -2 (rows): tab (G, S, W), idx (G, I, J = W), out (G, I, W).
// axis -1 (lanes): tab (G, I, W), idx (G, I, J), out (G, I, J).
// Strides are in elements; out is contiguous.
extern "C" int lane_gather(int axis, const void* tab, long long G,
                           long long S, long long W, long long ts0,
                           long long ts1, long long ts2, const void* idx,
                           long long I, long long J, long long is0,
                           long long is1, long long is2, void* out,
                           void* stream) {
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
  if (axis == -2 && S * W * 4 <= kStageBytes && I >= S &&
      G >= sm_count()) {
    const size_t smem = (size_t)(S * W * 4);
    if (small) {
      rows_staged<int><<<(unsigned)G, kThreads, smem, s>>>(
          t, (int)S, (int)W, ts0, ts1, ts2, x, (int)I, is0, is1, is2, o);
    } else {
      rows_staged<long long><<<(unsigned)G, kThreads, smem, s>>>(
          t, S, W, ts0, ts1, ts2, x, I, is0, is1, is2, o);
    }
  } else if (axis == -2 && small) {
    rows_global<int><<<grid_for(n), kThreads, 0, s>>>(
        t, (int)W, ts0, ts1, ts2, x, (int)I, is0, is1, is2, o, (int)n);
  } else if (axis == -2) {
    rows_global<long long><<<grid_for(n), kThreads, 0, s>>>(
        t, W, ts0, ts1, ts2, x, I, is0, is1, is2, o, n);
  } else if (small) {
    lanes_global<int><<<grid_for(n), kThreads, 0, s>>>(
        t, ts0, ts1, ts2, x, (int)I, (int)J, is0, is1, is2, o, (int)n);
  } else {
    lanes_global<long long><<<grid_for(n), kThreads, 0, s>>>(
        t, ts0, ts1, ts2, x, I, J, is0, is1, is2, o, n);
  }
  return (int)cudaGetLastError();
}
