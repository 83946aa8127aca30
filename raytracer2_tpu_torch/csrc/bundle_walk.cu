// Closest-hit bundle walk for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer2_tpu/ops/pallas_traverse.py::_walk_kernel
// (closest_hit_bundle_pallas). What it computes is unchanged: each bundle of
// P rays walks its candidate clusters nearest first, `group` clusters per
// step, tests every ray against every triangle of those clusters with the
// Wald unit-triangle transform, and keeps per ray the packed min key
//     key = (bits(t) & ~SLOT_MASK) | slot,   slot = g * S_pad + lane,
// which orders hits by t (low mantissa bits dropped) and then by slot. The
// winner is emitted as a code cluster * S_pad + lane (0x7FFFFFFF = miss),
// which the host decodes through one meta-row gather. A step's keys are
// unique (the slot is in the low bits) and a later step replaces the winner
// only with a strictly smaller key, so ties resolve exactly as on the TPU.
// A lane that hits nothing leaves the ray untouched (the TPU kernel's
// MISS_KEY sentinel could win only for a t_max above 1.7e38, which no caller
// passes).
//
// Layout on this card:
// - one thread block per bundle, one thread per ray (P = 128 or 256);
// - each step stages the `group` candidates' Wald rows (12 x S_pad floats
//   per cluster) from global into shared memory, cooperatively and
//   coalesced, then every thread tests its ray against all group*S_pad
//   lanes (walk_common.cuh, shared with the any-hit walk);
// - before each step the block takes the max over its rays of
//   float(best_key | SLOT_MASK) and stops once the next candidate's entry
//   distance exceeds it (the TPU kernel's conservative early exit; a NaN in
//   any lane ends the walk, as the TPU's NaN-propagating max does).
//
// What bounds it: the FP32 lane work of the Wald test (20 multiplies, 18
// adds, one IEEE divide and five compares per ray and triangle), then the
// L2 traffic of re-staging the Wald rows for every bundle that visits a
// cluster (6 KB per cluster per visit; the rows read are 19 MB for the
// 3,072 clusters of a 260k-triangle scene, inside the 50 MB L2). The
// divide is a true IEEE divide and no multiply-add is fused (--fmad=false),
// so the kernel agrees bit for bit with the plain torch version in
// ops/cuda_traverse.py. Later work: stage with TMA/cp.async behind the
// compute, exit per warp instead of per block, and take the affines to
// wgmma.

#include "walk_common.cuh"

namespace {

using rt2::kCoeffRows;
using rt2::kMaxGroup;

constexpr int kSlotMask = (1 << 10) - 1;
constexpr int kMissCode = 0x7FFFFFFF;

__global__ void __launch_bounds__(rt2::kMaxBundle, rt2::kMinBlocks)
walk_closest_kernel(const float* __restrict__ rays8,
                    const int* __restrict__ cand_idx,
                    const float* __restrict__ cand_t,
                    const int* __restrict__ cand_count,
                    const float* __restrict__ wald,
                    int* __restrict__ out_code,
                    int k, int s_pad, int group) {
  extern __shared__ float smem[];
  const int w_lanes = group * s_pad;
  float* tile = smem;                               // [12][w_lanes]
  float* warp_worst = smem + kCoeffRows * w_lanes;  // [32]
  __shared__ int group_ci[kMaxGroup];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(b) * blockDim.x + tid;
  const rt2::Ray r = rt2::load_ray(rays8, ray);

  // init from t_max: IEEE bits are monotone for t >= 0, dead rays
  // (t_max < 0) get a negative key no hit can beat; the low bits are set
  // so a hit at exactly t_max still wins
  int best_key = (__float_as_int(r.tx) & ~kSlotMask) | kSlotMask;
  int best_code = kMissCode;

  const int n_cand = cand_count[b];
  const int* ci_row = cand_idx + static_cast<long long>(b) * k;
  const float* ct_row = cand_t + static_cast<long long>(b) * k;

  for (int k0 = 0; k0 < n_cand; k0 += group) {
    // early exit; the barrier also ends the previous step's tile reads
    const float worst_mine = __int_as_float(best_key | kSlotMask);
    const int any_nan = __syncthreads_or(isnan(worst_mine));
    const float worst = rt2::block_max(worst_mine, warp_worst);
    if (any_nan || !(ct_row[k0] <= worst)) break;

    const int n_grp = min(group, n_cand - k0);
    if (tid < n_grp) group_ci[tid] = ci_row[k0 + tid];
    rt2::stage_rows(tile, wald, ci_row + k0, n_grp, s_pad, w_lanes);

    // group members past n_cand were never staged: the lane loop stops
    // at the live ones (the TPU kernel masks them)
    const int lanes = n_grp * s_pad;
    for (int s = 0; s < lanes; ++s) {
      float t;
      if (rt2::wald_test(r, tile, s, w_lanes, t)) {
        const int key = (__float_as_int(t) & ~kSlotMask) | s;
        if (key < best_key) {
          const int g = s / s_pad;
          best_key = key;
          best_code = group_ci[g] * s_pad + (s - g * s_pad);
        }
      }
    }
  }
  out_code[ray] = best_code;
}

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, wald [C, 16, s_pad] f32, out_code [n_bundles*p] i32. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int rt2_walk_closest(const float* rays8, const int* cand_idx,
                     const float* cand_t, const int* cand_count,
                     const float* wald, int* out_code, int n_bundles, int p,
                     int k, int s_pad, int group, void* stream) {
  if (n_bundles <= 0) return 0;
  if (p <= 0 || p > rt2::kMaxBundle || p % 32 != 0 || group < 1 ||
      group > kMaxGroup || group * s_pad > rt2::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (kCoeffRows * group * s_pad + 32);
  cudaError_t err = cudaFuncSetAttribute(
      walk_closest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_closest_kernel<<<n_bundles, p, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rays8, cand_idx, cand_t, cand_count, wald, out_code, k, s_pad, group);
  return static_cast<int>(cudaGetLastError());
}

const char* rt2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
