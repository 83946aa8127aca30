// Code the bundle walks share (bundle_walk.cu, bundle_occlude.cu, each in a
// cluster and a supercluster form, at ring depths 1-4, and in a tensor-core
// form for mm=True; pair_sweep.cu runs the same ring over a supercluster's
// members): the ray rows and limits, the cp.async ring's copies, the
// lane-major Wald test and its tensor-core twin (3xTF32 mma.sync), the
// float order the early exit reduces over, the longest-first bundle order,
// and the walks' launch and occupancy on the host.
//
// The test's affines contract their multiply-adds as XLA's CPU backend does
// in the JAX package's _intersect_block: explicit __fmaf_rn where XLA fuses,
// every other multiply and add rounded on its own (--fmad=false keeps nvcc
// from contracting more), in the order of the plain torch version
// (ops/wald.py::hit_test), so the walks agree with their plain
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
constexpr int kRing = 4;      // cluster slots in shared memory (the default
                              // depth; the walks also build depths 1-3)
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

// The cluster ring both walks stage through: kDepth slots of s_pad lanes in
// shared memory, filled with cp.async kDepth - 1 candidates ahead of the one
// being tested, one commit group per candidate. A walk calls prime() once;
// then for candidate j: cp_async_wait<kDepth - 2>() and a barrier (candidate
// j is in its slot and every thread is done with candidate j - 1's), then
// refill(j), then tests tile(j)'s first lanes(j) lanes. At kDepth 1 no copy
// runs ahead: the barrier retires candidate j - 1's slot, refill(j) copies
// candidate j into it, and cp_async_wait<0>() and a second barrier publish
// it (ring_ready). The cluster id and lane count of the next copies are
// loaded an iteration early, so that those loads wait behind a cluster
// test.
//
// kSc (supercluster mode, cull="sc"): the list holds supercluster ids, and
// ring entry q is member q % sc_m of supercluster ci_row[q / sc_m], i.e.
// cluster ci_row[q / sc_m] * sc_m + q % sc_m; the members past the last
// cluster (n_clusters) stage no lane. n_cand then counts members.
template <bool kSc = false, int kDepth = kRing>
struct ClusterRing {
  float4* slots;  // [kDepth][s_pad * kChunks], shared
  int* slot_lanes;  // [kDepth], shared: the lanes staged in each slot
  const float4* coeffs;  // [C, s_pad, 12] lane-major
  const int* lane_count;  // [C]
  const int* ci_row;  // the bundle's candidates
  int n_cand, s_pad;
  int sc_m, n_clusters;  // supercluster mode only
  int ci_next, lanes_next, ci_after;

  // The cluster of ring entry q (q < n_cand).
  __device__ __forceinline__ int cluster(int q) const {
    if constexpr (kSc) {
      return ci_row[q / sc_m] * sc_m + q % sc_m;
    } else {
      return ci_row[q];
    }
  }

  // The lanes cluster ci stages and tests.
  __device__ __forceinline__ int lanes_of(int ci) const {
    if constexpr (kSc) {
      return ci < n_clusters ? lane_count[ci] : 0;
    } else {
      return lane_count[ci];
    }
  }

  // Starts the copies of candidates 0 .. kDepth - 2.
  __device__ __forceinline__ void prime() {
    for (int q = 0; q < kDepth - 1; ++q) {
      if (q < n_cand) {
        const int ci = cluster(q);
        const int lanes = lanes_of(ci);
        if (threadIdx.x == 0) slot_lanes[q] = lanes;
        stage_cluster(slots + q * s_pad * kChunks, coeffs, ci, lanes, s_pad);
      }
      cp_async_commit();
    }
    ci_next = kDepth - 1 < n_cand ? cluster(kDepth - 1) : 0;
    lanes_next = lanes_of(ci_next);
    ci_after = kDepth < n_cand ? cluster(kDepth) : 0;
  }

  // Starts the copies of candidate j + kDepth - 1 into the slot candidate
  // j - 1 used (one commit group, empty past the list).
  __device__ __forceinline__ void refill(int j) {
    const int jn = j + kDepth - 1;
    if (jn < n_cand) {
      const int slot = jn % kDepth;
      if (threadIdx.x == 0) slot_lanes[slot] = lanes_next;
      stage_cluster(slots + slot * s_pad * kChunks, coeffs, ci_next,
                    lanes_next, s_pad);
      ci_next = ci_after;
      lanes_next = lanes_of(ci_after);
      ci_after = jn + 2 < n_cand ? cluster(jn + 2) : 0;
    }
    cp_async_commit();
  }

  __device__ __forceinline__ const float4* tile(int j) const {
    return slots + (j % kDepth) * s_pad * kChunks;
  }

  __device__ __forceinline__ int lanes(int j) const {
    return slot_lanes[j % kDepth];
  }
};

// Before candidate j's barrier: this thread's copies of candidate j are
// done (kDepth > 1; at kDepth 1 they start only after the barrier).
template <int kDepth>
__device__ __forceinline__ void ring_wait() {
  if constexpr (kDepth > 1) cp_async_wait<kDepth - 2>();
}

// After refill(j): at kDepth 1 the copies of candidate j, just started,
// are waited for and published; deeper rings published them at the
// barrier before.
template <int kDepth>
__device__ __forceinline__ void ring_ready() {
  if constexpr (kDepth == 1) {
    cp_async_wait<0>();
    __syncthreads();
  }
}

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

// The tensor-core form of the test (mm=True; JAX's _intersect_block_mm):
// the six affines of a warp's 32 rays against 8 lanes are three products
// [o | 1] @ W_c and three [d | 0] @ W_c, c in (u, v, z), each an
// mma.sync m16n8k4 TF32 tile per 16 rays. TF32 keeps 10 mantissa bits,
// so each operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// a product is lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32): what it drops,
// lo_a lo_b and lo's own rounding, is below 2^-21 |a b|, and the tensor
// core sums in float32. The fragments (PTX ISA, mma.m16n8k4 .tf32): lane
// l = 4 g + c of a warp holds A[g][c] and A[g + 8][c] of a 16x4 tile,
// B[c][g] of the 4x8 tile, and D[g][2c], D[g][2c + 1], D[g + 8][2c],
// D[g + 8][2c + 1] of the 16x8 result: all six affines of a (ray, lane)
// pair land on one thread, which then divides and compares as the lane
// test does, with u = op_u + t dp_u unfused (JAX's form).
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct Tf32Pair {
  unsigned hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const unsigned hi = tf32_bits(x);
  return Tf32Pair{hi, tf32_bits(__fsub_rn(x, __uint_as_float(hi)))};
}

// d += a b for one m16n8k4 TF32 tile (a0, a1: rows g and g + 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// d += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32Pair& a0,
                                           const Tf32Pair& a1,
                                           const Tf32Pair& b) {
  mma_tf32(d, a0.lo, a1.lo, b.hi);
  mma_tf32(d, a0.hi, a1.hi, b.lo);
  mma_tf32(d, a0.hi, a1.hi, b.hi);
}

// The affines of the 16-ray tile whose A fragments are (o0, o1) for the
// origins and (d0, d1) for the directions, against B fragments w[c] of
// lane n0 + g: acc[c] the origin affines (u, v, z), acc[3 + c] the
// direction's, in the D layout.
__device__ __forceinline__ void wald_tile_mm(float (&acc)[6][4],
                                             const Tf32Pair& o0,
                                             const Tf32Pair& o1,
                                             const Tf32Pair& d0,
                                             const Tf32Pair& d1,
                                             const Tf32Pair (&w)[3]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mma_3xtf32(acc[c], o0, o1, w[c]);
    mma_3xtf32(acc[3 + c], d0, d1, w[c]);
  }
}

// The test's predicates on one (ray, lane) of wald_tile_mm's output: sets
// t and returns |d'_z| > 1e-12 && u >= 0 && v >= 0 && u + v <= 1 && t >
// t_min, with u = op_u + t dp_u rounded twice (JAX's mm form).
__device__ __forceinline__ bool wald_mm_hit(float op_u, float op_v,
                                            float op_z, float dp_u,
                                            float dp_v, float dp_z, float tn,
                                            float& t) {
  t = __fdiv_rn(-op_z, dp_z);
  const float uu = __fadd_rn(op_u, __fmul_rn(t, dp_u));
  const float vv = __fadd_rn(op_v, __fmul_rn(t, dp_v));
  return fabsf(dp_z) > 1e-12f && uu >= 0.0f && vv >= 0.0f &&
         __fadd_rn(uu, vv) <= 1.0f && t > tn;
}

// The tensor-core form's view of one warp's 32 rays: lane 4 g + c holds
// rays g, g + 8, g + 16, g + 24 of the warp (q = 0..3; tiles of 16: rows g
// and g + 8 of each) and, of each, input c of [o | 1] and [d | 0] split to
// TF32 (its A fragments), and t_min and t_max.
struct MmRays {
  Tf32Pair o[4], d[4];
  float tn[4], tx[4];
  long long ray[4];
};

__device__ __forceinline__ MmRays load_mm_rays(const float* rays8,
                                               long long warp_first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  MmRays m;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m.ray[q] = warp_first + g + 8 * q;
    const float* r = rays8 + m.ray[q] * 8;
    m.o[q] = split_tf32(c < 3 ? r[c] : 1.0f);
    m.d[q] = split_tf32(c < 3 ? r[3 + c] : 0.0f);
    m.tn[q] = r[6];
    m.tx[q] = r[7];
  }
  return m;
}

// The B fragments of lane n0 + g of a slot (lane-major u, v, z float4s of
// inputs x, y, z, bias): input c of each output, split to TF32.
__device__ __forceinline__ void load_mm_lane(const float4* tile, int n0,
                                             Tf32Pair (&w)[3]) {
  const int lane = threadIdx.x & 31;
  const float* col = reinterpret_cast<const float*>(tile) +
                     (n0 + (lane >> 2)) * kChunks * 4 + (lane & 3);
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = split_tf32(col[c * 4]);
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

// Shared bytes of a ring of `depth` cluster slots of s_pad lanes.
size_t ring_bytes(int s_pad, int depth = kRing) {
  return sizeof(float4) * depth * kChunks * static_cast<size_t>(s_pad);
}

// A walk kernel's arguments: rays8, cand_idx, cand_t, cand_count, the
// lane-major coeffs and lane_count, the bundle order; out (a code, a
// blocked flag, or under lean the best key), aux (lean: the winning step,
// -1 on a miss; else null), steps (debug_steps: the steps each bundle
// took; else null); and the shapes. A block walks the bundles blockIdx.x,
// blockIdx.x + gridDim.x, ... of the order, at most mb of them.
struct WalkArgs {
  const float* rays8;
  const int* cand_idx;
  const float* cand_t;
  const int* cand_count;
  const float4* coeffs;
  const int* lane_count;
  const int* order;
  int* out;
  int* aux;
  int* steps;
  int n_bundles, k, s_pad, group, sc_m, n_clusters, mb;
};

using WalkKernel = void (*)(WalkArgs);

// A walk's launch: checks the shapes, orders the bundles longest first
// into a.order (bundle_order_kernel), then runs `kernel` (a ring of
// `depth` slots) with ceil(n_bundles / mb) blocks of p threads, all on
// `stream`. sc_m > 0 launches a supercluster walk (group == sc_m,
// n_clusters = C). Returns a cudaError_t (0 on success).
int launch_walk(WalkKernel kernel, int depth, WalkArgs a, int p,
                void* stream) {
  if (a.n_bundles <= 0) return 0;
  if (kernel == nullptr || p <= 0 || p > kMaxBundle || p % 32 != 0 ||
      a.group < 1 || a.group > kMaxGroup || a.s_pad <= 0 ||
      a.group * a.s_pad > kMaxLanes || a.k < 1 || a.sc_m < 0 ||
      a.mb < 1 || (a.sc_m > 0 && (a.group != a.sc_m || a.n_clusters < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int bins = a.k + 1 < kOrderBins ? a.k + 1 : kOrderBins;
  bundle_order_kernel<<<1, kOrderThreads, sizeof(int) * bins, s>>>(
      a.cand_count, a.n_bundles, bins, const_cast<int*>(a.order));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_bytes(a.s_pad, depth);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.n_bundles + a.mb - 1) / a.mb;
  kernel<<<blocks, p, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM of a walk kernel (a ring of `depth`
// slots) at p threads a block and s_pad lanes a cluster, p, registers per
// thread, shared bytes per block. Returns a cudaError_t (0 on success).
int walk_occupancy(WalkKernel kernel, int depth, int p, int s_pad,
                   int* out) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_bytes(s_pad, depth);
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

// The instance K<kSc, kDepth, kMm>::get() of a walk kernel for a launch:
// the supercluster form has no tensor-core twin (null, refused).
template <template <bool, int, bool> class K>
WalkKernel pick_walk(bool sc, int depth, bool mm) {
  if (sc && mm) return nullptr;
  switch (depth * 4 + (sc ? 2 : 0) + (mm ? 1 : 0)) {
    case 4: return K<false, 1, false>::get();
    case 5: return K<false, 1, true>::get();
    case 6: return K<true, 1, false>::get();
    case 8: return K<false, 2, false>::get();
    case 9: return K<false, 2, true>::get();
    case 10: return K<true, 2, false>::get();
    case 12: return K<false, 3, false>::get();
    case 13: return K<false, 3, true>::get();
    case 14: return K<true, 3, false>::get();
    case 16: return K<false, 4, false>::get();
    case 17: return K<false, 4, true>::get();
    case 18: return K<true, 4, false>::get();
    default: return nullptr;
  }
}

}  // namespace
}  // namespace rt2
