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
//
// The TPU walk's knobs (occluded_bundle_pallas's depth, mb, debug_steps,
// mm) as in bundle_walk.cu: the ring's depth a template parameter (1-4),
// mb bundles a block in turn, each bundle's steps as one more output, and
// the tensor-core form (walk_occluded_kernel<false, kDepth, true>): a
// warp's 32 rays against 8 lanes a tile (walk_common.cuh::wald_tile_mm),
// each thread folding its 4 rays' hits over its own lanes and the 4
// threads of a ray meeting where a group starts (the exit: done rays
// leave the max) and at the end; a warp whose rays are all done skips its
// tiles. Held to its plain version only up to rounding ties.

#include <climits>

#include "walk_common.cuh"

namespace {

using rt2::kChunks;
using rt2::kMaxBundle;
using rt2::WalkArgs;

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

// One bundle, one thread per ray (the lane test).
template <bool kSc, int kDepth>
__device__ __forceinline__ void occlude_lanes(
    const WalkArgs& a, int bundle, float4* ring, int* slot_lanes,
    int (*warp_worst)[kMaxBundle / 32]) {
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const long long ray = static_cast<long long>(bundle) * blockDim.x + tid;
  const rt2::Ray r = rt2::load_ray(a.rays8, ray);

  // padded rays carry t_max <= t_min and are done from the start
  bool done = r.tx <= r.tn;

  // ring entries: candidates, or in supercluster mode their members
  const int n_cand =
      kSc ? a.cand_count[bundle] * a.sc_m : a.cand_count[bundle];
  const int* ci_row = a.cand_idx + static_cast<long long>(bundle) * a.k;
  const float* ct_row = a.cand_t + static_cast<long long>(bundle) * a.k;
  rt2::ClusterRing<kSc, kDepth> cr{ring, slot_lanes, a.coeffs, a.lane_count,
                                   ci_row, n_cand, a.s_pad, a.sc_m,
                                   a.n_clusters};
  cr.prime();

  int buf = 0;    // warp_worst half of this group start
  int g = 0;      // j % group
  int steps = 0;  // groups started
  for (int j = 0; j < n_cand; ++j) {
    if (g == 0) {
      const float live_tx = done ? -INFINITY : r.tx;
      const int w = __reduce_max_sync(
          0xffffffffu, rt2::float_order(__float_as_int(live_tx)));
      if ((tid & 31) == 0) warp_worst[buf][tid >> 5] = w;
    }
    rt2::ring_wait<kDepth>();  // this thread's copies of cluster j
    // cluster j is in its slot (depth > 1), every thread is done with
    // cluster j - 1's slot, and the warps' maxima are written
    __syncthreads();
    if (g == 0) {
      const bool on = rt2::walk_goes_on(warp_worst[buf], n_warps,
                                        ct_row + (kSc ? j / a.sc_m : j));
      buf ^= 1;  // the next group start writes the other half
      if (!on) break;
      ++steps;
    }
    cr.refill(j);
    rt2::ring_ready<kDepth>();

    if (!done) done = blocks_ray(r, cr.tile(j), cr.lanes(j));
    g = g + 1 == a.group ? 0 : g + 1;
  }
  rt2::cp_async_wait<0>();  // no copy outlives the bundle

  a.out[ray] = (done && r.tx > r.tn) ? 1 : 0;
  if (a.steps != nullptr && tid == 0) a.steps[bundle] = steps;
}

// Whether any of the 4 threads that hold a ray saw it blocked.
__device__ __forceinline__ bool quad_any(bool hit) {
  int h = hit;
  h |= __shfl_xor_sync(0xffffffffu, h, 1);
  h |= __shfl_xor_sync(0xffffffffu, h, 2);
  return h != 0;
}

// One bundle in the tensor-core form (walk_common.cuh::wald_tile_mm).
template <int kDepth>
__device__ __forceinline__ void occlude_mm(const WalkArgs& a, int bundle,
                                           float4* ring, int* slot_lanes,
                                           int (*warp_worst)[kMaxBundle / 32]) {
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int tig = tid & 3;
  const rt2::MmRays m = rt2::load_mm_rays(
      a.rays8, static_cast<long long>(bundle) * blockDim.x + (tid & ~31));
  // per ray q: blocked by one of this thread's lanes (padding: from the
  // start)
  bool done_q[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) done_q[q] = m.tx[q] <= m.tn[q];

  const int n_cand = a.cand_count[bundle];
  const int* ci_row = a.cand_idx + static_cast<long long>(bundle) * a.k;
  const float* ct_row = a.cand_t + static_cast<long long>(bundle) * a.k;
  rt2::ClusterRing<false, kDepth> cr{ring, slot_lanes, a.coeffs,
                                     a.lane_count, ci_row, n_cand, a.s_pad,
                                     0, 0};
  cr.prime();

  int buf = 0, g = 0, steps = 0;
  bool warp_done = false;  // every ray of the warp blocked
  for (int j = 0; j < n_cand; ++j) {
    if (g == 0) {
      int w = INT_MIN;
      bool all = true;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        done_q[q] = quad_any(done_q[q]);
        all = all && done_q[q];
        const float live_tx = done_q[q] ? -INFINITY : m.tx[q];
        w = max(w, rt2::float_order(__float_as_int(live_tx)));
      }
      w = __reduce_max_sync(0xffffffffu, w);
      warp_done = __all_sync(0xffffffffu, all);
      if ((tid & 31) == 0) warp_worst[buf][tid >> 5] = w;
    }
    rt2::ring_wait<kDepth>();
    __syncthreads();
    if (g == 0) {
      const bool on = rt2::walk_goes_on(warp_worst[buf], n_warps, ct_row + j);
      buf ^= 1;
      if (!on) break;
      ++steps;
    }
    cr.refill(j);
    rt2::ring_ready<kDepth>();

    if (!warp_done) {
      const float4* tile = cr.tile(j);
      const int lanes = cr.lanes(j);
      for (int n0 = 0; n0 < lanes; n0 += 8) {
        rt2::Tf32Pair w[3];
        rt2::load_mm_lane(tile, n0, w);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float acc[6][4];
          rt2::wald_tile_mm(acc, m.o[2 * mt], m.o[2 * mt + 1], m.d[2 * mt],
                            m.d[2 * mt + 1], w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = 2 * mt + (i >> 1);
            const int l = n0 + 2 * tig + (i & 1);
            float t;
            const bool hit =
                rt2::wald_mm_hit(acc[0][i], acc[1][i], acc[2][i], acc[3][i],
                                 acc[4][i], acc[5][i], m.tn[q], t) &&
                t < m.tx[q] && l < lanes;
            done_q[q] = done_q[q] || hit;
          }
        }
      }
    }
    g = g + 1 == a.group ? 0 : g + 1;
  }
  rt2::cp_async_wait<0>();

  // thread 4 g + c writes ray q = c of its four (selects, not an indexed
  // read, which would put the arrays in local memory)
  bool blocked = false;
  long long ray = m.ray[0];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool d = quad_any(done_q[q]) && m.tx[q] > m.tn[q];
    if (tig == q) {
      blocked = d;
      ray = m.ray[q];
    }
  }
  a.out[ray] = blocked ? 1 : 0;
  if (a.steps != nullptr && tid == 0) a.steps[bundle] = steps;
}

// kSc: the supercluster walk, as in bundle_walk.cu; kDepth: the ring's
// slots; kMm: the tensor-core form (not with kSc). Blocks of kMaxBundle
// threads per SM: 4 at <= 64 registers, 2 for the tensor-core form.
template <bool kSc, int kDepth, bool kMm>
__global__ void __launch_bounds__(kMaxBundle, kMm ? 2 : 4)
walk_occluded_kernel(const WalkArgs a) {
  extern __shared__ float4 ring[];  // [kDepth][s_pad * kChunks]
  __shared__ int slot_lanes[kDepth];
  __shared__ int warp_worst[2][kMaxBundle / 32];
  for (int q = 0; q < a.mb; ++q) {
    const int idx = blockIdx.x + q * gridDim.x;
    if (idx >= a.n_bundles) break;
    if (q > 0) __syncthreads();  // the last bundle is done with the ring
    if constexpr (kMm) {
      occlude_mm<kDepth>(a, a.order[idx], ring, slot_lanes, warp_worst);
    } else {
      occlude_lanes<kSc, kDepth>(a, a.order[idx], ring, slot_lanes,
                                 warp_worst);
    }
  }
}

template <bool kSc, int kDepth, bool kMm>
struct OccludedWalk {
  static rt2::WalkKernel get() {
    return walk_occluded_kernel<kSc, kDepth, kMm>;
  }
};

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, coeffs [C, s_pad, 12] f32 and lane_count [C] i32 (WalkLanes),
// order [n_bundles] i32 scratch, out [n_bundles*p] i32 (blocked), aux
// unused (null), steps [n_bundles] i32 (debug_steps; or null). sc_m,
// n_clusters, depth, mb and mm as rt2_walk_closest's. Launches the bundle
// order and the walk on `stream` and returns cudaGetLastError() (0 on
// success).
int rt2_walk_occluded(const float* rays8, const int* cand_idx,
                      const float* cand_t, const int* cand_count,
                      const float* coeffs, const int* lane_count, int* order,
                      int* out, int* aux, int* steps, int n_bundles, int p,
                      int k, int s_pad, int group, int sc_m, int n_clusters,
                      int depth, int mb, int mm, void* stream) {
  if (aux != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const WalkArgs a{rays8, cand_idx, cand_t, cand_count,
                   reinterpret_cast<const float4*>(coeffs), lane_count,
                   order, out, nullptr, steps, n_bundles, k, s_pad, group,
                   sc_m, n_clusters, mb};
  return rt2::launch_walk(
      rt2::pick_walk<OccludedWalk>(sc_m > 0, depth, mm != 0), depth, a, p,
      stream);
}

// out[4]: resident blocks per SM of the instance (sc, depth, mm) at p
// threads a block and s_pad lanes a cluster, p, registers per thread,
// shared bytes per block. Returns a cudaError_t (0 on success).
int rt2_walk_occluded_occupancy(int p, int s_pad, int sc, int depth, int mm,
                                int* out) {
  return rt2::walk_occupancy(
      rt2::pick_walk<OccludedWalk>(sc != 0, depth, mm != 0), depth, p, s_pad,
      out);
}

}  // extern "C"
