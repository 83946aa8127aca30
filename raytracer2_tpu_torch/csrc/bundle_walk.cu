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
// A lane that hits nothing leaves the ray untouched. (The TPU kernel's
// MISS_KEY sentinel wins over a t_max above 1.7e38, such as the FLT_MAX of
// a BRDF candidate ray with brdf_cutoff 0, and then reports a hit on a
// slot the ray missed; here, as in the plain version, the ray misses.)
// Before each step the bundle takes the max over its rays of
// float(best_key | SLOT_MASK) and stops once the next candidate's entry
// distance exceeds it, a NaN in any ray ending the walk.
//
// What bounds it on this card: the issue rate of the FP32 lane work. One
// (ray, triangle) test is 6 multiplies, 14 FMAs (the multiply-adds XLA
// contracts in the reference, walk_common.cuh::wald_lane_test), 4 adds, an
// IEEE divide (a reciprocal, four FFMAs and a range check), five compares
// and a key update, ~41 instructions (nothing else fuses, --fmad=false):
// one warp instruction per clock per scheduler caps it at ~55% of the FP32
// bound, which counts an FMA as two operations (~40% before the Wald test
// fused its multiply-adds); it runs at ~31% of it
// on a 2,073,600-ray bounce batch (PERF.md). The table reads are
// L2 traffic (19 MB of coefficients for the 3,072 clusters of a
// 260k-triangle scene, inside the 50 MB L2).
//
// The design (one block per bundle, one thread per ray):
// - longest first: a one-block counting sort orders the bundles by
//   decreasing candidate count and block i walks bundle order[i], so the
//   few long walks (sky and grazing bundles, up to k candidates) overlap
//   the many short ones instead of ending the batch alone;
// - real lanes only: `lane_count[c]` (ops/cuda_traverse.py::walk_lanes) is
//   1 + the last lane of cluster c with a nonzero coefficient; the real
//   triangles are a prefix of each cluster row and every lane past them is
//   zero (d'_z == 0, never a hit), so neither staging nor testing them
//   changes a bit, and the slot numbering stays g * S_pad + lane;
// - a ring of kRing cluster slots in shared memory, filled with cp.async
//   16-byte copies kRing - 1 clusters ahead of the one being tested, one
//   commit group per cluster; one barrier per cluster both publishes its
//   copies and retires the slot the next copy overwrites. Shared memory is
//   kRing * S_pad * 48 bytes whatever `group` is (24 KB at S_pad = 128), so
//   both classes keep at least 32 warps per SM: 9 blocks of 128 rays
//   (bounces, group 8) or 4 of 256 (pixel tiles, group 4) at the 52
//   registers the unrolled loop takes (ptxas on sm_90a);
// - lane-major coefficients (WalkLanes.coeffs, [C, S_pad, 12] in the
//   order u, v, z of (x, y, z, bias)): a test reads three 16-byte
//   broadcasts instead of twelve 4-byte ones, and the lane loop is unrolled
//   so each warp has independent tests between the divides;
// - clusters are tested one at a time in walk order, each lane folding its
//   key into the ray's with a min, and the cluster that last lowered the key
//   is remembered: the min over a step's unique keys is the same whether
//   its clusters come together or in turn, a key equal to the best of an
//   earlier step changes nothing (the strict < of the step rule), and the
//   winner's lane is its key's slot less g * S_pad;
// - the early exit is tested where a group starts, from one max per warp
//   (redux.sync over the float order written as ints, NaN as INT_MAX)
//   written before that cluster's barrier and read after it: no barrier of
//   its own.
// The affines fuse exactly the multiply-adds the plain torch version fuses
// (ops/wald.py::hit_test: XLA's contraction, explicit __fmaf_rn
// here, nothing else fused), the divide is IEEE, so the kernel agrees with
// walk_closest_reference bit for bit.
//
// The any-hit walk (bundle_occlude.cu) shares this design and its helpers
// (walk_common.cuh: the cluster ring, the group-start exit, the lane test,
// the bundle order, the launch and the occupancy).
//
// Supercluster mode (rt2_walk_closest_sc, the kSc instance; the TPU
// kernel's sc_m > 0 branch): each candidate is a supercluster of sc_m
// clusters laid side by side, walked in one step, with group forced to
// sc_m. Here the ring takes the supercluster's members in turn as a
// group's clusters, reading the cluster tables (no supercluster copy of
// them), so a step is the same group of sc_m clusters the TPU walks at
// once and the exit is tested before each supercluster; the members past
// C stage and test nothing (the TPU's zero rows never hit). The member's
// slot g * S_pad + lane and its cluster s * sc_m + g give JAX's winner
// code.

#include <climits>

#include "walk_common.cuh"

namespace {

using rt2::cp_async_wait;
using rt2::float_order;
using rt2::kChunks;
using rt2::kMaxBundle;
using rt2::kRing;

constexpr int kSlotMask = (1 << 10) - 1;
constexpr int kMissCode = 0x7FFFFFFF;
constexpr int kMinBlocks = 4;  // of kMaxBundle threads: <= 64 registers

// kSc: the supercluster walk (cull="sc", group == sc_m): candidate s of
// the list is the clusters s*sc_m .. s*sc_m + sc_m - 1, the ring walks them
// as group members (ClusterRing<true>), and the exit test where a group
// starts reads supercluster s's entry distance. A member's slot is
// g * S_pad + lane, JAX's SC-mode slot, and its cluster decodes the winner.
template <bool kSc>
__global__ void __launch_bounds__(kMaxBundle, kMinBlocks)
walk_closest_kernel(const float* __restrict__ rays8,
                    const int* __restrict__ cand_idx,
                    const float* __restrict__ cand_t,
                    const int* __restrict__ cand_count,
                    const float4* __restrict__ coeffs,
                    const int* __restrict__ lane_count,
                    const int* __restrict__ order,
                    int* __restrict__ out_code, int k, int s_pad,
                    int group, int sc_m, int n_clusters) {
  extern __shared__ float4 ring[];  // [kRing][s_pad * kChunks]
  __shared__ int slot_lanes[kRing];
  __shared__ int warp_worst[2][kMaxBundle / 32];

  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int bundle = order[blockIdx.x];
  const long long ray = static_cast<long long>(bundle) * blockDim.x + tid;
  const rt2::Ray r = rt2::load_ray(rays8, ray);

  // init from t_max: IEEE bits are monotone for t >= 0, dead rays
  // (t_max < 0) get a negative key no hit can beat; the low bits are set
  // so a hit at exactly t_max still wins
  int best_key = (__float_as_int(r.tx) & ~kSlotMask) | kSlotMask;
  int best_j = -1;  // the candidate whose lane set best_key

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
      const int w = __reduce_max_sync(0xffffffffu,
                                      float_order(best_key | kSlotMask));
      if ((tid & 31) == 0) warp_worst[buf][tid >> 5] = w;
    }
    cp_async_wait<kRing - 2>();  // this thread's copies of cluster j
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

    const float4* tile = cr.tile(j);
    const int lanes = cr.lanes(j);
    const int s0 = g * s_pad;
    const int before = best_key;
#pragma unroll 4
    for (int l = 0; l < lanes; ++l) {
      float t;
      const bool hit = rt2::wald_lane_test(r, tile[l * kChunks + 0],
                                           tile[l * kChunks + 1],
                                           tile[l * kChunks + 2], t);
      const int key = (__float_as_int(t) & ~kSlotMask) | (s0 + l);
      if (hit) best_key = min(best_key, key);
    }
    if (best_key != before) best_j = j;
    g = g + 1 == group ? 0 : g + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block

  int code = kMissCode;
  if (best_j >= 0) {
    const int lane = (best_key & kSlotMask) - (best_j % group) * s_pad;
    code = cr.cluster(best_j) * s_pad + lane;
  }
  out_code[ray] = code;
}

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, coeffs [C, s_pad, 12] f32 and lane_count [C] i32 (WalkLanes),
// order [n_bundles] i32 scratch, out_code [n_bundles*p] i32. Launches the
// bundle order and the walk on `stream` and returns cudaGetLastError() (0
// on success).
int rt2_walk_closest(const float* rays8, const int* cand_idx,
                     const float* cand_t, const int* cand_count,
                     const float* coeffs, const int* lane_count, int* order,
                     int* out_code, int n_bundles, int p, int k, int s_pad,
                     int group, void* stream) {
  return rt2::launch_walk(walk_closest_kernel<false>, rays8, cand_idx, cand_t,
                          cand_count, coeffs, lane_count, order, out_code,
                          n_bundles, p, k, s_pad, group, 0, 0, stream);
}

// The supercluster walk: as rt2_walk_closest, with cand_idx holding
// supercluster ids of sc_m clusters each (group == sc_m) and n_clusters
// the clusters of coeffs and lane_count.
int rt2_walk_closest_sc(const float* rays8, const int* cand_idx,
                        const float* cand_t, const int* cand_count,
                        const float* coeffs, const int* lane_count,
                        int* order, int* out_code, int n_bundles, int p,
                        int k, int s_pad, int group, int sc_m, int n_clusters,
                        void* stream) {
  return rt2::launch_walk(walk_closest_kernel<true>, rays8, cand_idx, cand_t,
                          cand_count, coeffs, lane_count, order, out_code,
                          n_bundles, p, k, s_pad, group, sc_m, n_clusters,
                          stream);
}

// out[4]: resident blocks per SM at p threads a block and s_pad lanes a
// cluster, p, registers per thread, shared bytes per block. Returns a
// cudaError_t (0 on success).
int rt2_walk_closest_occupancy(int p, int s_pad, int* out) {
  return rt2::walk_occupancy(walk_closest_kernel<false>, p, s_pad, out);
}

int rt2_walk_closest_sc_occupancy(int p, int s_pad, int* out) {
  return rt2::walk_occupancy(walk_closest_kernel<true>, p, s_pad, out);
}

const char* rt2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
