// Device code of the bundle walks: the ray rows and the limits both walks
// share (bundle_walk.cu, bundle_occlude.cu), and the any-hit walk's
// row-major staging of a step's Wald rows into shared memory, its Wald
// unit-triangle test and its block-wide max of the early exit (the
// closest-hit walk stages lane-major rows through its own ring).
//
// The test's affines are written in the order the plain torch versions
// write them (ops/cuda_traverse.py::_wald_test). With --fmad=false every
// multiply and add rounds on its own, so both walks agree with their plain
// versions bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt2 {

constexpr int kWaldRows = 16;   // rows per cluster in the table (12 used)
constexpr int kCoeffRows = 12;
constexpr int kMaxGroup = 8;    // group * S_pad <= 1 << 10
constexpr int kMaxLanes = 1 << 10;
// One thread per ray, at most kMaxBundle rays per bundle. The any-hit
// kernel is declared __launch_bounds__(kMaxBundle, kMinBlocks), which holds
// it to 32 registers: eight 256-thread blocks fit on an SM.
constexpr int kMaxBundle = 256;
constexpr int kMinBlocks = 8;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tx;
};

__device__ __forceinline__ Ray load_ray(const float* rays8, long long ray) {
  const float* r = rays8 + ray * 8;
  return Ray{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
}

// Max of v over the block: a warp shuffle, one shared word per warp
// (warp_words, 32 floats), a barrier, then every thread reads the words. The
// caller puts a barrier between these reads and the next call's writes.
__device__ __forceinline__ float block_max(float v, float* warp_words) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_words[threadIdx.x >> 5] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  float m = warp_words[0];
  for (int i = 1; i < n_warps; ++i) m = fmaxf(m, warp_words[i]);
  return m;
}

// Stages the Wald rows (12 x s_pad floats each) of clusters ci[0:n_grp] into
// tile[12][w_lanes], cluster g at lanes g * s_pad + lane. The block copies
// cooperatively: i runs over (g, row, lane) in the table's own order, so
// neighbouring threads read neighbouring words. Ends with a barrier.
__device__ __forceinline__ void stage_rows(float* tile,
                                           const float* __restrict__ wald,
                                           const int* ci, int n_grp,
                                           int s_pad, int w_lanes) {
  const int per_cluster = kCoeffRows * s_pad;
  for (int i = threadIdx.x; i < n_grp * per_cluster; i += blockDim.x) {
    const int g = i / per_cluster;
    const int rem = i - g * per_cluster;
    const int row = rem / s_pad;
    const int lane = rem - row * s_pad;
    const long long c = ci[g];
    tile[row * w_lanes + g * s_pad + lane] =
        wald[(c * kWaldRows + row) * s_pad + lane];
  }
  __syncthreads();
}

// The Wald unit-triangle test of ray r against lane s of the staged tile
// (row k*3 + c holds input k = x, y, z, bias of output c = u, v, z): sets t
// and returns |d'_z| > 1e-12 && u >= 0 && v >= 0 && u + v <= 1 && t > t_min.
// Each coefficient is a shared-memory broadcast. A padding lane has zero
// rows (d'_z == 0) and never hits.
__device__ __forceinline__ bool wald_test(const Ray& r, const float* tile,
                                          int s, int w_lanes, float& t) {
  const float* w = tile + s;
  const float w0 = w[0 * w_lanes], w1 = w[1 * w_lanes];
  const float w2 = w[2 * w_lanes], w3 = w[3 * w_lanes];
  const float w4 = w[4 * w_lanes], w5 = w[5 * w_lanes];
  const float w6 = w[6 * w_lanes], w7 = w[7 * w_lanes];
  const float w8 = w[8 * w_lanes], w9 = w[9 * w_lanes];
  const float w10 = w[10 * w_lanes], w11 = w[11 * w_lanes];
  const float op_u = ((r.ox * w0 + r.oy * w3) + r.oz * w6) + w9;
  const float op_v = ((r.ox * w1 + r.oy * w4) + r.oz * w7) + w10;
  const float op_z = ((r.ox * w2 + r.oy * w5) + r.oz * w8) + w11;
  const float dp_u = (r.dx * w0 + r.dy * w3) + r.dz * w6;
  const float dp_v = (r.dx * w1 + r.dy * w4) + r.dz * w7;
  const float dp_z = (r.dx * w2 + r.dy * w5) + r.dz * w8;
  t = -op_z / dp_z;
  const float uu = op_u + t * dp_u;
  const float vv = op_v + t * dp_v;
  return fabsf(dp_z) > 1e-12f && uu >= 0.0f && vv >= 0.0f &&
         uu + vv <= 1.0f && t > r.tn;
}

}  // namespace rt2
