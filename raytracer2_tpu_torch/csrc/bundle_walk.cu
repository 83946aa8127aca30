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
//
// The function-level knobs of the TPU walk (closest_hit_bundle_pallas's
// depth, mb, lean, debug_steps, mm), none of which changes a hit:
// - depth: the ring's slot count, a template parameter (kDepth 1-4; 4 is
//   the card's default, the TPU's was 2). At depth 1 no copy is in flight
//   while a cluster is tested, and each cluster takes two barriers;
// - mb: the bundles one block walks in turn (block i: bundles i, i + B/mb,
//   ... of the longest-first order, so long walks stay spread over the
//   blocks); the ring and the exit buffer start afresh for each;
// - lean: the output is the best key and the winning step (-1 on a miss)
//   instead of the code; the host recovers the cluster from the step and
//   the key's slot with one gather into the candidate table;
// - debug_steps: each bundle's steps (groups started, early exit
//   included) as one more output;
// - mm (walk_closest_kernel<false, kDepth, true>): the six affines run on
//   the tensor cores, 3xTF32 mma.sync tiles of 16 rays by 8 lanes
//   (walk_common.cuh::wald_tile_mm). A thread then holds 4 rays x 2 lanes
//   of a tile; it keeps per ray the least key and the candidate that set
//   it over its own lanes, and the 4 threads of a ray meet in 2 shuffles
//   where a group starts (the exit) and at the end. The products are not
//   float32's own roundings, so this form is held to its plain version
//   (ops/cuda_traverse.py::hit_test_mm) only up to rounding ties. What
//   bounds it: per (ray, lane) 18/128 of an mma a warp (0.14 issue
//   slots) beside a divide and ~12 FP32 instructions, against the ~41 of
//   the lane test; the TF32 splits of the coefficients are made once per
//   8 lanes for 32 rays.

#include <climits>

#include "walk_common.cuh"

namespace {

using rt2::cp_async_wait;
using rt2::float_order;
using rt2::kChunks;
using rt2::kMaxBundle;
using rt2::WalkArgs;

constexpr int kSlotMask = (1 << 10) - 1;
constexpr int kMissCode = 0x7FFFFFFF;

// The bundle's result for one ray: under lean (a.aux set) the best key and
// the winning step, else the code cluster * S_pad + lane (kMissCode on a
// miss). best_j is the ring entry whose lane set best_key, -1 if none.
template <bool kSc, int kDepth>
__device__ __forceinline__ void write_ray(const WalkArgs& a,
                                          const rt2::ClusterRing<kSc, kDepth>& cr,
                                          long long ray, int best_key,
                                          int best_j) {
  if (a.aux != nullptr) {
    a.out[ray] = best_key;
    a.aux[ray] = best_j >= 0 ? best_j / a.group : -1;
    return;
  }
  int code = kMissCode;
  if (best_j >= 0) {
    const int lane = (best_key & kSlotMask) - (best_j % a.group) * a.s_pad;
    code = cr.cluster(best_j) * a.s_pad + lane;
  }
  a.out[ray] = code;
}

// One bundle, one thread per ray (the lane test).
template <bool kSc, int kDepth>
__device__ __forceinline__ void walk_lanes(const WalkArgs& a, int bundle,
                                           float4* ring, int* slot_lanes,
                                           int (*warp_worst)[kMaxBundle / 32]) {
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const long long ray = static_cast<long long>(bundle) * blockDim.x + tid;
  const rt2::Ray r = rt2::load_ray(a.rays8, ray);

  // init from t_max: IEEE bits are monotone for t >= 0, dead rays
  // (t_max < 0) get a negative key no hit can beat; the low bits are set
  // so a hit at exactly t_max still wins
  int best_key = (__float_as_int(r.tx) & ~kSlotMask) | kSlotMask;
  int best_j = -1;  // the candidate whose lane set best_key

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
      const int w = __reduce_max_sync(0xffffffffu,
                                      float_order(best_key | kSlotMask));
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

    const float4* tile = cr.tile(j);
    const int lanes = cr.lanes(j);
    const int s0 = g * a.s_pad;
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
    g = g + 1 == a.group ? 0 : g + 1;
  }
  cp_async_wait<0>();  // no copy outlives the bundle

  write_ray(a, cr, ray, best_key, best_j);
  if (a.steps != nullptr && tid == 0) a.steps[bundle] = steps;
}

// The least key of ray q over the 4 threads that hold it.
__device__ __forceinline__ int quad_min(int key) {
  key = min(key, __shfl_xor_sync(0xffffffffu, key, 1));
  return min(key, __shfl_xor_sync(0xffffffffu, key, 2));
}

// One bundle in the tensor-core form (walk_common.cuh::wald_tile_mm): a
// warp tests its 32 rays against each cluster 8 lanes at a time.
template <int kDepth>
__device__ __forceinline__ void walk_mm(const WalkArgs& a, int bundle,
                                        float4* ring, int* slot_lanes,
                                        int (*warp_worst)[kMaxBundle / 32]) {
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int tig = tid & 3;
  const rt2::MmRays m = rt2::load_mm_rays(
      a.rays8, static_cast<long long>(bundle) * blockDim.x + (tid & ~31));
  // per ray q: the least key over this thread's lanes and its entry
  int key_q[4], j_q[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    key_q[q] = (__float_as_int(m.tx[q]) & ~kSlotMask) | kSlotMask;
    j_q[q] = -1;
  }

  const int n_cand = a.cand_count[bundle];
  const int* ci_row = a.cand_idx + static_cast<long long>(bundle) * a.k;
  const float* ct_row = a.cand_t + static_cast<long long>(bundle) * a.k;
  rt2::ClusterRing<false, kDepth> cr{ring, slot_lanes, a.coeffs,
                                     a.lane_count, ci_row, n_cand, a.s_pad,
                                     0, 0};
  cr.prime();

  int buf = 0, g = 0, steps = 0;
  for (int j = 0; j < n_cand; ++j) {
    if (g == 0) {
      int w = INT_MIN;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w = max(w, float_order(quad_min(key_q[q]) | kSlotMask));
      }
      w = __reduce_max_sync(0xffffffffu, w);
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

    const float4* tile = cr.tile(j);
    const int lanes = cr.lanes(j);
    const int s0 = g * a.s_pad;
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
          const bool hit = rt2::wald_mm_hit(acc[0][i], acc[1][i], acc[2][i],
                                            acc[3][i], acc[4][i], acc[5][i],
                                            m.tn[q], t) && l < lanes;
          const int key = (__float_as_int(t) & ~kSlotMask) | (s0 + l);
          if (hit && key < key_q[q]) {
            key_q[q] = key;
            j_q[q] = j;
          }
        }
      }
    }
    g = g + 1 == a.group ? 0 : g + 1;
  }
  cp_async_wait<0>();

  // the 4 threads of a ray meet: the least key, and the entry of the
  // thread that holds it (a lane's slot belongs to one thread, so equal
  // keys come from one thread)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, key_q[q], x);
      const int oj = __shfl_xor_sync(0xffffffffu, j_q[q], x);
      if (ok < key_q[q]) {
        key_q[q] = ok;
        j_q[q] = oj;
      }
    }
  }
  // thread 4 g + c writes ray q = c of its four (selects, not an indexed
  // read, which would put the arrays in local memory)
  int key = key_q[0], best_j = j_q[0];
  long long ray = m.ray[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (tig == q) {
      key = key_q[q];
      best_j = j_q[q];
      ray = m.ray[q];
    }
  }
  write_ray(a, cr, ray, key, best_j);
  if (a.steps != nullptr && tid == 0) a.steps[bundle] = steps;
}

// kSc: the supercluster walk (cull="sc", group == sc_m): candidate s of
// the list is the clusters s*sc_m .. s*sc_m + sc_m - 1, the ring walks them
// as group members (ClusterRing<true>), and the exit test where a group
// starts reads supercluster s's entry distance. A member's slot is
// g * S_pad + lane, JAX's SC-mode slot, and its cluster decodes the winner.
// kDepth: the ring's slots; kMm: the tensor-core form (not with kSc).
// Blocks of kMaxBundle threads per SM: the lane test fits in 64 registers
// (4), the tensor-core form keeps its A fragments and 24 accumulators in
// 128 (2).
template <bool kSc, int kDepth, bool kMm>
__global__ void __launch_bounds__(kMaxBundle, kMm ? 2 : 4)
walk_closest_kernel(const WalkArgs a) {
  extern __shared__ float4 ring[];  // [kDepth][s_pad * kChunks]
  __shared__ int slot_lanes[kDepth];
  __shared__ int warp_worst[2][kMaxBundle / 32];
  for (int q = 0; q < a.mb; ++q) {
    const int idx = blockIdx.x + q * gridDim.x;
    if (idx >= a.n_bundles) break;
    if (q > 0) __syncthreads();  // the last bundle is done with the ring
    if constexpr (kMm) {
      walk_mm<kDepth>(a, a.order[idx], ring, slot_lanes, warp_worst);
    } else {
      walk_lanes<kSc, kDepth>(a, a.order[idx], ring, slot_lanes,
                              warp_worst);
    }
  }
}

template <bool kSc, int kDepth, bool kMm>
struct ClosestWalk {
  static rt2::WalkKernel get() {
    return walk_closest_kernel<kSc, kDepth, kMm>;
  }
};

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, coeffs [C, s_pad, 12] f32 and lane_count [C] i32 (WalkLanes),
// order [n_bundles] i32 scratch, out [n_bundles*p] i32 (the code, or
// under lean the best key), aux [n_bundles*p] i32 (lean: the winning
// step; null otherwise), steps [n_bundles] i32 (debug_steps; or null).
// sc_m > 0: a supercluster walk (cand_idx holds supercluster ids of sc_m
// clusters each, group == sc_m, n_clusters the clusters of coeffs). depth
// 1-4: the ring's slots; mb >= 1: bundles a block walks; mm: the
// tensor-core form (not with sc_m > 0). Launches the bundle order and the
// walk on `stream` and returns cudaGetLastError() (0 on success).
int rt2_walk_closest(const float* rays8, const int* cand_idx,
                     const float* cand_t, const int* cand_count,
                     const float* coeffs, const int* lane_count, int* order,
                     int* out, int* aux, int* steps, int n_bundles, int p,
                     int k, int s_pad, int group, int sc_m, int n_clusters,
                     int depth, int mb, int mm, void* stream) {
  const WalkArgs a{rays8, cand_idx, cand_t, cand_count,
                   reinterpret_cast<const float4*>(coeffs), lane_count,
                   order, out, aux, steps, n_bundles, k, s_pad, group, sc_m,
                   n_clusters, mb};
  return rt2::launch_walk(
      rt2::pick_walk<ClosestWalk>(sc_m > 0, depth, mm != 0), depth, a, p,
      stream);
}

// out[4]: resident blocks per SM of the instance (sc, depth, mm) at p
// threads a block and s_pad lanes a cluster, p, registers per thread,
// shared bytes per block. Returns a cudaError_t (0 on success).
int rt2_walk_closest_occupancy(int p, int s_pad, int sc, int depth, int mm,
                               int* out) {
  return rt2::walk_occupancy(
      rt2::pick_walk<ClosestWalk>(sc != 0, depth, mm != 0), depth, p, s_pad,
      out);
}

const char* rt2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
