// Any-hit bundle walk for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer2_tpu/ops/pallas_traverse.py::_occlude_kernel
// (occluded_bundle_pallas). What it computes is unchanged: each bundle of P
// visibility rays walks its candidate clusters nearest first, `group`
// clusters per step, and a ray is done at its first hit with
//     |d'_z| > 1e-12, u >= 0, v >= 0, u + v <= 1, t_min < t < t_max
// under the Wald unit-triangle transform. Lanes past the bundle's candidate
// count are never staged (the TPU kernel masks them). Padded rays
// (t_max <= t_min) start done and report 0. The output is 1 for a blocked
// ray and 0 otherwise; there is no winner to keep, so no packed key.
//
// Layout on this card, as in bundle_walk.cu:
// - one thread block per bundle, one thread per ray (P = 128);
// - each step stages the `group` candidates' Wald rows (12 x S_pad floats
//   per cluster) into shared memory, cooperatively and coalesced, and every
//   live thread tests its ray against them lane by lane, reading each
//   coefficient as a shared-memory broadcast, until its first hit;
// - before each step the block takes, by warp shuffle and one shared word
//   per warp, the largest t_max of its rays that are not done yet (-inf
//   once all are done) and stops when the next candidate's entry distance
//   exceeds it; a NaN t_max of a live ray ends the walk, as the TPU's
//   NaN-propagating max does. A block-wide vote on "all done" ends it as
//   soon as every ray is blocked.
//
// What bounds it: the FP32 lane work of the Wald test (20 multiplies, 18
// adds, one IEEE divide and six compares per ray and triangle lane, cut
// short at the first hit), then the L2 traffic of re-staging each visited
// cluster's rows (6 KB) per bundle. The staging and the Wald test are
// bundle_walk.cu's (walk_common.cuh), built with --fmad=false, so a hit here
// is a hit in the plain torch version (ops/cuda_traverse.py) bit for bit. Later work:
// stage with TMA/cp.async behind the compute and retire warps whose rays are
// all done instead of letting them idle to the block's exit.

#include "walk_common.cuh"

namespace {

using rt2::kCoeffRows;
using rt2::kMaxGroup;

__global__ void __launch_bounds__(rt2::kMaxBundle, rt2::kMinBlocks)
walk_occluded_kernel(const float* __restrict__ rays8,
                     const int* __restrict__ cand_idx,
                     const float* __restrict__ cand_t,
                     const int* __restrict__ cand_count,
                     const float* __restrict__ wald,
                     int* __restrict__ out_blocked,
                     int k, int s_pad, int group) {
  extern __shared__ float smem[];
  const int w_lanes = group * s_pad;
  float* tile = smem;                               // [12][w_lanes]
  float* warp_worst = smem + kCoeffRows * w_lanes;  // [32]

  const int b = blockIdx.x;
  const long long ray = static_cast<long long>(b) * blockDim.x + threadIdx.x;
  const rt2::Ray r = rt2::load_ray(rays8, ray);

  // padded rays carry t_max <= t_min and are done from the start
  bool done = r.tx <= r.tn;

  const int n_cand = cand_count[b];
  const int* ci_row = cand_idx + static_cast<long long>(b) * k;
  const float* ct_row = cand_t + static_cast<long long>(b) * k;

  for (int k0 = 0; k0 < n_cand; k0 += group) {
    // exits; the barriers also end the previous step's tile reads
    const float live_tx = done ? -INFINITY : r.tx;
    const int any_nan = __syncthreads_or(isnan(live_tx));
    const int all_done = __syncthreads_and(done);
    const float worst = rt2::block_max(live_tx, warp_worst);
    if (all_done || any_nan || !(ct_row[k0] <= worst)) break;

    const int n_grp = min(group, n_cand - k0);
    rt2::stage_rows(tile, wald, ci_row + k0, n_grp, s_pad, w_lanes);

    if (done) continue;
    const int lanes = n_grp * s_pad;
    for (int s = 0; s < lanes; ++s) {
      float t;
      if (rt2::wald_test(r, tile, s, w_lanes, t) && t < r.tx) {
        done = true;
        break;
      }
    }
  }
  out_blocked[ray] = (done && r.tx > r.tn) ? 1 : 0;
}

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, wald [C, 16, s_pad] f32, out_blocked [n_bundles*p] i32. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int rt2_walk_occluded(const float* rays8, const int* cand_idx,
                      const float* cand_t, const int* cand_count,
                      const float* wald, int* out_blocked, int n_bundles,
                      int p, int k, int s_pad, int group, void* stream) {
  if (n_bundles <= 0) return 0;
  if (p <= 0 || p > rt2::kMaxBundle || p % 32 != 0 || group < 1 ||
      group > kMaxGroup || group * s_pad > rt2::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (kCoeffRows * group * s_pad + 32);
  cudaError_t err = cudaFuncSetAttribute(
      walk_occluded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_occluded_kernel<<<n_bundles, p, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rays8, cand_idx, cand_t, cand_count, wald, out_blocked, k, s_pad,
      group);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
