// Any-hit bundle walk for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer2_tpu/ops/pallas_traverse.py::_occlude_kernel
// (occluded_bundle_pallas). What it computes is unchanged: each bundle of P
// visibility rays walks its candidate clusters nearest first, `group`
// clusters per step, and a ray is done at its first hit with
//     |d'_z| > 1e-12, u >= 0, v >= 0, u + v <= 1, t_min < t < t_max
// under the Wald unit-triangle transform. Padded rays (t_max <= t_min)
// start done and report 0. Where a step starts, the bundle stops if its
// candidates are exhausted or the next candidate's entry distance is not
// <= the largest t_max of its rays not yet done, taken after the whole
// previous step: -inf once every ray is done, NaN (the walk ends) if a live
// ray's t_max is NaN, as the TPU's NaN-propagating max. The output is 1 for
// a blocked ray and 0 otherwise (blocked = done && t_max > t_min); there is
// no winner to keep, so no packed key.
//
// What bounds it on this card: the instruction rate of the FP32 lane work,
// as in bundle_walk.cu (a test is 20 multiplies, 18 adds, an IEEE divide
// and six compares, ~55 instructions, none fused), and here also the lanes
// a warp keeps testing for its last rays once the others are done: the
// bound counts each ray's tests only up to its first hit. It runs at ~18%
// of the bound on the DI frame's visibility batch (PERF.md).
//
// The design is the closest-hit walk's (bundle_walk.cu; its helpers are in
// walk_common.cuh): one block per bundle, one thread per ray, the bundles
// longest first, real lanes only (WalkLanes.count: a padding lane never
// hits, so leaving it untested changes no flag), a ring of kRing cluster
// slots filled with cp.async kRing - 1 clusters ahead with one barrier per
// cluster (shared memory kRing * S_pad * 48 bytes whatever `group` is: 24 KB
// at S_pad 128), lane-major coefficients read as three 16-byte broadcasts a
// test. Where it differs:
// - the walk goes cluster by cluster, each ray testing the lanes of each
//   cluster until its first hit, four lanes at a time (the four tests are
//   independent, so a warp has work between the divides; a hit among them
//   ends the ray); a thread whose ray is done tests nothing, so a warp
//   whose rays are all done only takes part in the copies and barriers;
// - the exit stays at group boundaries: where a group starts, each warp
//   writes the max of float_order(done ? -inf : t_max) over its rays
//   (redux.sync; NaN is INT_MAX) before that cluster's barrier, and after
//   it every thread reads the warps' maxima: INT_MAX (a NaN) ends the walk,
//   as does an entry distance not <= the max (the order of -inf once every
//   ray is done). Which rays are done at the end of a step does not depend
//   on the order of its clusters and lanes (a ray is done if any of them
//   hits it, and a done ray never tests again), so testing the step's
//   clusters in turn, and a ray stopping inside a step, change no flag.
// The affines fuse exactly the multiply-adds the plain torch version fuses
// (ops/wald.py::hit_test: XLA's contraction, explicit __fmaf_rn
// here, nothing else fused), the divide is IEEE, so a hit here is a hit in
// walk_occluded_reference bit for bit.
//
// Supercluster mode (rt2_walk_occluded_sc, the TPU kernel's sc_m > 0
// branch) walks each supercluster's members as one group, as
// bundle_walk.cu does; the exit is tested before each supercluster.

#include <climits>

#include "walk_common.cuh"

namespace {

using rt2::kChunks;
using rt2::kMaxBundle;
using rt2::kRing;

constexpr int kMinBlocks = 4;  // of kMaxBundle threads: <= 64 registers
constexpr int kLaneStep = 4;   // lanes tested together before a hit ends

// Tests ray r against the first `lanes` lanes of a slot until the first
// hit inside (t_min, t_max); returns whether one hit.
__device__ __forceinline__ bool blocks_ray(const rt2::Ray& r,
                                           const float4* tile, int lanes) {
  int l = 0;
  for (; l + kLaneStep <= lanes; l += kLaneStep) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < kLaneStep; ++q) {
      const float4* w = tile + (l + q) * kChunks;
      float t;
      const bool h = rt2::wald_lane_test(r, w[0], w[1], w[2], t);
      hit |= h && t < r.tx;
    }
    if (hit) return true;
  }
  for (; l < lanes; ++l) {
    const float4* w = tile + l * kChunks;
    float t;
    if (rt2::wald_lane_test(r, w[0], w[1], w[2], t) && t < r.tx) return true;
  }
  return false;
}

// kSc: the supercluster walk, as in bundle_walk.cu.
template <bool kSc>
__global__ void __launch_bounds__(kMaxBundle, kMinBlocks)
walk_occluded_kernel(const float* __restrict__ rays8,
                     const int* __restrict__ cand_idx,
                     const float* __restrict__ cand_t,
                     const int* __restrict__ cand_count,
                     const float4* __restrict__ coeffs,
                     const int* __restrict__ lane_count,
                     const int* __restrict__ order,
                     int* __restrict__ out_blocked, int k, int s_pad,
                     int group, int sc_m, int n_clusters) {
  extern __shared__ float4 ring[];  // [kRing][s_pad * kChunks]
  __shared__ int slot_lanes[kRing];
  __shared__ int warp_worst[2][kMaxBundle / 32];

  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int bundle = order[blockIdx.x];
  const long long ray = static_cast<long long>(bundle) * blockDim.x + tid;
  const rt2::Ray r = rt2::load_ray(rays8, ray);

  // padded rays carry t_max <= t_min and are done from the start
  bool done = r.tx <= r.tn;

  // ring entries: candidates, or in supercluster mode their members
  const int n_cand = kSc ? cand_count[bundle] * sc_m : cand_count[bundle];
  const int* ci_row = cand_idx + static_cast<long long>(bundle) * k;
  const float* ct_row = cand_t + static_cast<long long>(bundle) * k;
  rt2::ClusterRing<kSc> cr{ring, slot_lanes, coeffs, lane_count, ci_row,
                           n_cand, s_pad, sc_m, n_clusters};
  cr.prime();

  int buf = 0;  // warp_worst half of this group start
  int g = 0;    // j % group
  for (int j = 0; j < n_cand; ++j) {
    if (g == 0) {
      const float live_tx = done ? -INFINITY : r.tx;
      const int w = __reduce_max_sync(
          0xffffffffu, rt2::float_order(__float_as_int(live_tx)));
      if ((tid & 31) == 0) warp_worst[buf][tid >> 5] = w;
    }
    rt2::cp_async_wait<kRing - 2>();  // this thread's copies of cluster j
    // cluster j is in its slot, every thread is done with cluster j - 1's
    // slot, and the warps' maxima are written
    __syncthreads();
    if (g == 0) {
      const bool on = rt2::walk_goes_on(warp_worst[buf], n_warps,
                                        ct_row + (kSc ? j / sc_m : j));
      buf ^= 1;  // the next group start writes the other half
      if (!on) break;
    }
    cr.refill(j);

    if (!done) done = blocks_ray(r, cr.tile(j), cr.lanes(j));
    g = g + 1 == group ? 0 : g + 1;
  }
  rt2::cp_async_wait<0>();  // no copy outlives the block

  out_blocked[ray] = (done && r.tx > r.tn) ? 1 : 0;
}

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, coeffs [C, s_pad, 12] f32 and lane_count [C] i32 (WalkLanes),
// order [n_bundles] i32 scratch, out_blocked [n_bundles*p] i32. Launches
// the bundle order and the walk on `stream` and returns cudaGetLastError()
// (0 on success).
int rt2_walk_occluded(const float* rays8, const int* cand_idx,
                      const float* cand_t, const int* cand_count,
                      const float* coeffs, const int* lane_count, int* order,
                      int* out_blocked, int n_bundles, int p, int k,
                      int s_pad, int group, void* stream) {
  return rt2::launch_walk(walk_occluded_kernel<false>, rays8, cand_idx,
                          cand_t, cand_count, coeffs, lane_count, order,
                          out_blocked, n_bundles, p, k, s_pad, group, 0, 0,
                          stream);
}

// The supercluster walk: as rt2_walk_occluded, with cand_idx holding
// supercluster ids of sc_m clusters each (group == sc_m) and n_clusters
// the clusters of coeffs and lane_count.
int rt2_walk_occluded_sc(const float* rays8, const int* cand_idx,
                         const float* cand_t, const int* cand_count,
                         const float* coeffs, const int* lane_count,
                         int* order, int* out_blocked, int n_bundles, int p,
                         int k, int s_pad, int group, int sc_m,
                         int n_clusters, void* stream) {
  return rt2::launch_walk(walk_occluded_kernel<true>, rays8, cand_idx,
                          cand_t, cand_count, coeffs, lane_count, order,
                          out_blocked, n_bundles, p, k, s_pad, group, sc_m,
                          n_clusters, stream);
}

// out[4]: resident blocks per SM at p threads a block and s_pad lanes a
// cluster, p, registers per thread, shared bytes per block. Returns a
// cudaError_t (0 on success).
int rt2_walk_occluded_occupancy(int p, int s_pad, int* out) {
  return rt2::walk_occupancy(walk_occluded_kernel<false>, p, s_pad, out);
}

int rt2_walk_occluded_sc_occupancy(int p, int s_pad, int* out) {
  return rt2::walk_occupancy(walk_occluded_kernel<true>, p, s_pad, out);
}

}  // extern "C"
