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
// passes). Before each step the bundle takes the max over its rays of
// float(best_key | SLOT_MASK) and stops once the next candidate's entry
// distance exceeds it, a NaN in any ray ending the walk.
//
// What bounds it on this card: the issue rate of the FP32 lane work. One
// (ray, triangle) test is 20 multiplies, 18 adds, an IEEE divide (a
// reciprocal, four FFMAs and a range check), five compares and a key
// update, ~55 instructions, all separately rounded (--fmad=false, so none
// fuse): one warp instruction per clock per scheduler caps it at ~40% of the
// FP32 bound, which counts an FMA as two operations; it runs at ~31% of it
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
// The affines are written in the order of the plain torch version
// (ops/cuda_traverse.py::_wald_test), the divide is IEEE, and nothing is
// fused, so the kernel agrees with walk_closest_reference bit for bit.
//
// The any-hit walk (bundle_occlude.cu) still stages row-major tiles
// through walk_common.cuh's stage_rows / wald_test / block_max.

#include <climits>

#include "walk_common.cuh"

namespace {

using rt2::kMaxBundle;
using rt2::kMaxGroup;
using rt2::kMaxLanes;

constexpr int kSlotMask = (1 << 10) - 1;
constexpr int kMissCode = 0x7FFFFFFF;
constexpr int kRing = 4;      // cluster slots in shared memory
constexpr int kChunks = 3;    // 16-byte vectors per lane: u, v, z rows
constexpr int kMinBlocks = 4;  // of kMaxBundle threads: <= 64 registers
constexpr int kOrderThreads = 1024;
constexpr int kOrderBins = 4096;  // counts above share the last bin

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float order of bits as an int order; NaN is INT_MAX (no other value
// maps there: a positive float's bits are below 0x7F800001, a negative
// one's map below 0).
__device__ __forceinline__ int float_order(int bits) {
  if (isnan(__int_as_float(bits))) return INT_MAX;
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

// Starts the copies of the first `lanes` lanes of cluster ci into a slot
// (lanes * kChunks 16-byte vectors, strided over the block).
__device__ __forceinline__ void stage_cluster(float4* slot,
                                              const float4* __restrict__ coeffs,
                                              int ci, int lanes, int s_pad) {
  const float4* src = coeffs + static_cast<long long>(ci) * s_pad * kChunks;
  for (int i = threadIdx.x; i < lanes * kChunks; i += blockDim.x) {
    cp_async16(slot + i, src + i);
  }
}

// The bundles in decreasing candidate count (a counting sort in one
// block over min(count, bins - 1); the order inside a bin is the
// atomics', which no result sees): the walk kernel's block i takes bundle
// order[i], so the few bundles with hundreds of candidates (sky and
// grazing pixel tiles) start first instead of running on alone at the end
// of the batch.
__global__ void __launch_bounds__(kOrderThreads)
bundle_order_kernel(const int* __restrict__ cand_count, int n_bundles,
                    int bins, int* __restrict__ order) {
  extern __shared__ int start[];  // [bins]: bundles per bin, then starts
  for (int v = threadIdx.x; v < bins; v += blockDim.x) start[v] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < n_bundles; b += blockDim.x) {
    atomicAdd(&start[min(max(cand_count[b], 0), bins - 1)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int v = bins - 1; v >= 0; --v) {
      const int n = start[v];
      start[v] = s;
      s += n;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bundles; b += blockDim.x) {
    order[atomicAdd(&start[min(max(cand_count[b], 0), bins - 1)], 1)] = b;
  }
}

__global__ void __launch_bounds__(kMaxBundle, kMinBlocks)
walk_closest_kernel(const float* __restrict__ rays8,
                    const int* __restrict__ cand_idx,
                    const float* __restrict__ cand_t,
                    const int* __restrict__ cand_count,
                    const float4* __restrict__ coeffs,
                    const int* __restrict__ lane_count,
                    const int* __restrict__ order,
                    int* __restrict__ out_code, int k, int s_pad,
                    int group) {
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

  const int n_cand = cand_count[bundle];
  const int* ci_row = cand_idx + static_cast<long long>(bundle) * k;
  const float* ct_row = cand_t + static_cast<long long>(bundle) * k;
  const int slot_size = s_pad * kChunks;

  // candidates 0 .. kRing - 2 in flight, one commit group each
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < n_cand) {
      const int ci = ci_row[q];
      const int lanes = lane_count[ci];
      if (tid == 0) slot_lanes[q] = lanes;
      stage_cluster(ring + q * slot_size, coeffs, ci, lanes, s_pad);
    }
    cp_async_commit();
  }
  // the cluster iteration j stages (j + kRing - 1) and the one after it,
  // loaded an iteration early so that the loads wait behind a cluster test
  int ci_next = kRing - 1 < n_cand ? ci_row[kRing - 1] : 0;
  int lanes_next = lane_count[ci_next];
  int ci_after = kRing < n_cand ? ci_row[kRing] : 0;

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
      int worst = warp_worst[buf][0];
      for (int w = 1; w < n_warps; ++w) worst = max(worst, warp_worst[buf][w]);
      buf ^= 1;  // the next group start writes the other half
      if (worst == INT_MAX ||
          !(ct_row[j] <= __int_as_float(worst >= 0 ? worst
                                                   : worst ^ 0x7FFFFFFF))) {
        break;
      }
    }
    // refill the slot cluster j - 1 used
    const int jn = j + kRing - 1;
    if (jn < n_cand) {
      const int slot = jn % kRing;
      if (tid == 0) slot_lanes[slot] = lanes_next;
      stage_cluster(ring + slot * slot_size, coeffs, ci_next, lanes_next,
                    s_pad);
      ci_next = ci_after;
      lanes_next = lane_count[ci_after];
      ci_after = jn + 2 < n_cand ? ci_row[jn + 2] : 0;
    }
    cp_async_commit();

    const int slot = j % kRing;
    const float4* tile = ring + slot * slot_size;
    const int lanes = slot_lanes[slot];
    const int s0 = g * s_pad;
    const int before = best_key;
#pragma unroll 4
    for (int l = 0; l < lanes; ++l) {
      const float4 u = tile[l * kChunks + 0];  // w0 w3 w6 w9
      const float4 v = tile[l * kChunks + 1];  // w1 w4 w7 w10
      const float4 z = tile[l * kChunks + 2];  // w2 w5 w8 w11
      const float op_u = ((r.ox * u.x + r.oy * u.y) + r.oz * u.z) + u.w;
      const float op_v = ((r.ox * v.x + r.oy * v.y) + r.oz * v.z) + v.w;
      const float op_z = ((r.ox * z.x + r.oy * z.y) + r.oz * z.z) + z.w;
      const float dp_u = (r.dx * u.x + r.dy * u.y) + r.dz * u.z;
      const float dp_v = (r.dx * v.x + r.dy * v.y) + r.dz * v.z;
      const float dp_z = (r.dx * z.x + r.dy * z.y) + r.dz * z.z;
      const float t = -op_z / dp_z;
      const float uu = op_u + t * dp_u;
      const float vv = op_v + t * dp_v;
      const bool hit = fabsf(dp_z) > 1e-12f && uu >= 0.0f && vv >= 0.0f &&
                       uu + vv <= 1.0f && t > r.tn;
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
    code = ci_row[best_j] * s_pad + lane;
  }
  out_code[ray] = code;
}

size_t ring_bytes(int s_pad) {
  return sizeof(float4) * kRing * kChunks * static_cast<size_t>(s_pad);
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
  if (n_bundles <= 0) return 0;
  if (p <= 0 || p > kMaxBundle || p % 32 != 0 || group < 1 ||
      group > kMaxGroup || s_pad <= 0 || group * s_pad > kMaxLanes ||
      k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int bins = k + 1 < kOrderBins ? k + 1 : kOrderBins;
  bundle_order_kernel<<<1, kOrderThreads, sizeof(int) * bins, s>>>(
      cand_count, n_bundles, bins, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_bytes(s_pad);
  err = cudaFuncSetAttribute(walk_closest_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_closest_kernel<<<n_bundles, p, smem, s>>>(
      rays8, cand_idx, cand_t, cand_count,
      reinterpret_cast<const float4*>(coeffs), lane_count, order, out_code,
      k, s_pad, group);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM at p threads a block and s_pad lanes a
// cluster, p, registers per thread, shared bytes per block. Returns a
// cudaError_t (0 on success).
int rt2_walk_closest_occupancy(int p, int s_pad, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, walk_closest_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_bytes(s_pad);
  err = cudaFuncSetAttribute(walk_closest_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, walk_closest_kernel, p, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = p;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

const char* rt2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
