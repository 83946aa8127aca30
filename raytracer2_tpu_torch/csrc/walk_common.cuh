// Code the bundle walks share (bundle_walk.cu, bundle_occlude.cu;
// pair_sweep.cu runs the same ring over a supercluster's members): the ray
// rows and limits, the cp.async ring's copies, the lane-major Wald test, the
// float order the early exit reduces over, the longest-first bundle order,
// and the walks' launch and occupancy on the host.
//
// The test's affines contract their multiply-adds as XLA's CPU backend does
// in the JAX package's _intersect_block: explicit __fmaf_rn where XLA fuses,
// every other multiply and add rounded on its own (--fmad=false keeps nvcc
// from contracting more), in the order of the plain torch version
// (ops/cuda_traverse.py::_wald_test), so the walks agree with their plain
// versions, and those with JAX's walks, bit for bit.

#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <math.h>

namespace rt2 {

constexpr int kMaxGroup = 8;    // group * S_pad <= 1 << 10
constexpr int kMaxLanes = 1 << 10;
// One thread per ray, at most kMaxBundle rays per bundle.
constexpr int kMaxBundle = 256;
constexpr int kRing = 4;      // cluster slots in shared memory
constexpr int kChunks = 3;    // 16-byte vectors per lane: u, v, z rows
constexpr int kOrderThreads = 1024;
constexpr int kOrderBins = 4096;  // counts above share the last bin

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tx;
};

__device__ __forceinline__ Ray load_ray(const float* rays8, long long ray) {
  const float* r = rays8 + ray * 8;
  return Ray{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
}

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

// The float whose float_order is `order` (not INT_MAX).
__device__ __forceinline__ float order_float(int order) {
  return __int_as_float(order >= 0 ? order : order ^ 0x7FFFFFFF);
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

// The cluster ring both walks stage through: kRing slots of s_pad lanes in
// shared memory, filled with cp.async kRing - 1 candidates ahead of the one
// being tested, one commit group per candidate. A walk calls prime() once;
// then for candidate j: cp_async_wait<kRing - 2>() and a barrier (candidate
// j is in its slot and every thread is done with candidate j - 1's), then
// refill(j), then tests tile(j)'s first lanes(j) lanes. The cluster id and
// lane count of the next copies are loaded an iteration early, so that
// those loads wait behind a cluster test.
struct ClusterRing {
  float4* slots;  // [kRing][s_pad * kChunks], shared
  int* slot_lanes;  // [kRing], shared: the lanes staged in each slot
  const float4* coeffs;  // [C, s_pad, 12] lane-major
  const int* lane_count;  // [C]
  const int* ci_row;  // the bundle's candidates
  int n_cand, s_pad;
  int ci_next, lanes_next, ci_after;

  // Starts the copies of candidates 0 .. kRing - 2.
  __device__ __forceinline__ void prime() {
    for (int q = 0; q < kRing - 1; ++q) {
      if (q < n_cand) {
        const int ci = ci_row[q];
        const int lanes = lane_count[ci];
        if (threadIdx.x == 0) slot_lanes[q] = lanes;
        stage_cluster(slots + q * s_pad * kChunks, coeffs, ci, lanes, s_pad);
      }
      cp_async_commit();
    }
    ci_next = kRing - 1 < n_cand ? ci_row[kRing - 1] : 0;
    lanes_next = lane_count[ci_next];
    ci_after = kRing < n_cand ? ci_row[kRing] : 0;
  }

  // Starts the copies of candidate j + kRing - 1 into the slot candidate
  // j - 1 used (one commit group, empty past the list).
  __device__ __forceinline__ void refill(int j) {
    const int jn = j + kRing - 1;
    if (jn < n_cand) {
      const int slot = jn % kRing;
      if (threadIdx.x == 0) slot_lanes[slot] = lanes_next;
      stage_cluster(slots + slot * s_pad * kChunks, coeffs, ci_next,
                    lanes_next, s_pad);
      ci_next = ci_after;
      lanes_next = lane_count[ci_after];
      ci_after = jn + 2 < n_cand ? ci_row[jn + 2] : 0;
    }
    cp_async_commit();
  }

  __device__ __forceinline__ const float4* tile(int j) const {
    return slots + (j % kRing) * s_pad * kChunks;
  }

  __device__ __forceinline__ int lanes(int j) const {
    return slot_lanes[j % kRing];
  }
};

// Where a group starts, after the barrier: whether the walk goes on, from
// the warps' maxima of float_order (written before the barrier) and the
// entry distance *ct of the group's first candidate. A NaN (INT_MAX) ends
// it, as does *ct not <= the max.
__device__ __forceinline__ bool walk_goes_on(const int* warp_worst,
                                             int n_warps, const float* ct) {
  int worst = warp_worst[0];
  for (int w = 1; w < n_warps; ++w) worst = max(worst, warp_worst[w]);
  return worst != INT_MAX && *ct <= order_float(worst);
}

// x wx + y wy + z wz as fma(z, wz, fma(x, wx, y * wy)), the pattern XLA
// contracts the affine into.
__device__ __forceinline__ float wald_affine(float x, float y, float z,
                                             float wx, float wy, float wz) {
  return __fmaf_rn(z, wz, __fmaf_rn(x, wx, __fmul_rn(y, wy)));
}

// The Wald unit-triangle test of ray r against one lane of lane-major
// coefficients (u: w0 w3 w6 w9, v: w1 w4 w7 w10, z: w2 w5 w8 w11; input
// x, y, z, bias of outputs u, v, z): sets t and returns |d'_z| > 1e-12 &&
// u >= 0 && v >= 0 && u + v <= 1 && t > t_min. The bias adds and the
// divide round on their own; u and v are one fma each. A padding lane (all
// zero) has d'_z == 0 and never hits.
__device__ __forceinline__ bool wald_lane_test(const Ray& r, const float4& u,
                                               const float4& v,
                                               const float4& z, float& t) {
  const float op_u = wald_affine(r.ox, r.oy, r.oz, u.x, u.y, u.z) + u.w;
  const float op_v = wald_affine(r.ox, r.oy, r.oz, v.x, v.y, v.z) + v.w;
  const float op_z = wald_affine(r.ox, r.oy, r.oz, z.x, z.y, z.z) + z.w;
  const float dp_u = wald_affine(r.dx, r.dy, r.dz, u.x, u.y, u.z);
  const float dp_v = wald_affine(r.dx, r.dy, r.dz, v.x, v.y, v.z);
  const float dp_z = wald_affine(r.dx, r.dy, r.dz, z.x, z.y, z.z);
  t = -op_z / dp_z;
  const float uu = __fmaf_rn(t, dp_u, op_u);
  const float vv = __fmaf_rn(t, dp_v, op_v);
  return fabsf(dp_z) > 1e-12f && uu >= 0.0f && vv >= 0.0f &&
         uu + vv <= 1.0f && t > r.tn;
}

namespace {

// The bundles in decreasing candidate count (a counting sort in one
// block over min(count, bins - 1); the order inside a bin is the
// atomics', which no result sees): a walk kernel's block i takes bundle
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

// Shared bytes of a ring of kRing cluster slots of s_pad lanes.
size_t ring_bytes(int s_pad) {
  return sizeof(float4) * kRing * kChunks * static_cast<size_t>(s_pad);
}

// The signature of both walk kernels: rays8, cand_idx, cand_t, cand_count,
// lane-major coeffs, lane_count, bundle order, out, k, s_pad, group.
using WalkKernel = void (*)(const float*, const int*, const float*,
                            const int*, const float4*, const int*,
                            const int*, int*, int, int, int);

// A walk's launch: checks the shapes, orders the bundles longest first
// into `order` (bundle_order_kernel), then runs `kernel` with one block of
// p threads per bundle and a ring of kRing slots, all on `stream`. Returns
// a cudaError_t (0 on success).
int launch_walk(WalkKernel kernel, const float* rays8, const int* cand_idx,
                const float* cand_t, const int* cand_count,
                const float* coeffs, const int* lane_count, int* order,
                int* out, int n_bundles, int p, int k, int s_pad, int group,
                void* stream) {
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
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_bundles, p, smem, s>>>(
      rays8, cand_idx, cand_t, cand_count,
      reinterpret_cast<const float4*>(coeffs), lane_count, order, out, k,
      s_pad, group);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM of a walk kernel at p threads a block and
// s_pad lanes a cluster, p, registers per thread, shared bytes per block.
// Returns a cudaError_t (0 on success).
int walk_occupancy(WalkKernel kernel, int p, int s_pad, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_bytes(s_pad);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, p,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = p;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

}  // namespace
}  // namespace rt2
