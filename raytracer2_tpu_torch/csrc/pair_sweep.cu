// Pair sweep of the pair engine for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer2_tpu/ops/pallas_pairs.py::_pair_kernel
// (_sweep_pairs). What it computes is unchanged: the (ray, supercluster)
// pairs come binned by supercluster into blocks of 128 rays, and each block
// tests its rays against every lane of its supercluster's Wald block
// [16, W] (W = group * S_pad, the group's clusters side by side). Per ray it
// keeps the min over the lanes of
//     key = (bits(t) & ~slot_mask) | slot,   slot = m * S_pad + lane
// for member cluster m, where the lane hits, MISS_KEY = 0x7F000000 where
// none does; a lane hits when |d'_z| > 1e-12, u >= 0, v >= 0, u + v <= 1
// and t_min < t < t_max (both ends open: the walks test only t > t_min). A
// dead block (block_live == 0) writes MISS_KEY for all its rays, and so does
// a block whose supercluster id is out of range. Dead pairs inside a live
// block carry t_max = -1 and never hit.
//
// What bounds it on this card: the issue rate of the FP32 lane work, as in
// the closest-hit walk (bundle_walk.cu): 45 FP32 operations per (live pair
// ray, real-triangle lane) counting an FMA as two: 6 multiplies, 14 FMAs,
// 4 adds, an IEEE divide and 6 compares (nothing else fused,
// --fmad=false), ~41 instructions with the key update. The bytes (the
// [tp, 8] pair rows, the keys, the coefficients of each swept
// supercluster) are two orders of magnitude below.
//
// The design: a pair block is a bundle whose candidates are exactly its
// supercluster's `group` member clusters sc * group + m, walked in full (the
// plain version has no early exit), so it runs the closest-hit walk's loop
// (walk_common.cuh) over that fixed list:
// - one block of 128 threads per pair block, one thread per ray, the ray
//   row read once; the member ids sit in shared memory as the ring's
//   candidate list;
// - it reads the walks' own table (ops/cuda_traverse.py::walk_lanes), as
//   member sc * group + m of wald_sc is cluster sc * group + m there; the
//   clusters that pad C to whole groups have zero rows in wald_sc (never a
//   hit) and no row in that table, so a block walks its
//   min(group, C - sc * group) real members only;
// - real lanes only: `lane_count[c]` is 1 + the last lane of cluster c with
//   a nonzero coefficient; every lane past it is zero (d'_z == 0, never a
//   hit), so skipping it changes no key;
// - the members pass through a ring of kRing cluster slots in shared memory,
//   filled with cp.async 16-byte copies kRing - 1 members ahead of the one
//   being tested, one barrier per member (24 KB at S_pad = 128: 9 blocks of
//   128 threads a SM);
// - lane-major coefficients ([C, S_pad, 12] in LANE_ROWS order):
//   a test reads three 16-byte broadcasts, and the lane loop is unrolled so
//   each warp has independent tests between the divides;
// - each thread keeps a running min of its int key, exact in any lane
//   order; a ray whose segment is empty (t_max <= t_min, or NaN) tests
//   nothing, so the warps of a block's trailing dead pairs skip the loop.
// The affines fuse exactly the multiply-adds the plain torch version fuses
// (ops/cuda_traverse.py::_wald_test, explicit __fmaf_rn here) and the
// divide is IEEE, so the kernel agrees with
// ops/cuda_pairs.py::pair_sweep_reference bit for bit.

#include "walk_common.cuh"

namespace {

using rt2::cp_async_wait;
using rt2::kChunks;
using rt2::kRing;

constexpr int kPairP = 128;         // rays per pair block
constexpr int kMaxLanes = 2048;     // W <= 2048: the slot rides in 11 bits
constexpr int kMaxPairGroup = 16;   // members per supercluster (S_pad >= 128)
constexpr int kMinBlocks = 8;       // of kPairP threads: <= 64 registers
constexpr int kMissKey = 0x7F000000;

__global__ void __launch_bounds__(kPairP, kMinBlocks)
pair_sweep_kernel(const float* __restrict__ rays8,
                  const int* __restrict__ block_sc,
                  const int* __restrict__ block_live,
                  const float4* __restrict__ coeffs,
                  const int* __restrict__ lane_count,
                  int* __restrict__ keys, int n_sc, int n_clusters,
                  int group, int s_pad, int slot_mask) {
  extern __shared__ float4 ring[];  // [kRing][s_pad * kChunks]
  __shared__ int slot_lanes[kRing];
  __shared__ int members[kMaxPairGroup];
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(blockIdx.x) * kPairP + tid;
  const int sc = block_sc[blockIdx.x];
  if (block_live[blockIdx.x] == 0 || sc < 0 || sc >= n_sc) {  // per block
    keys[ray] = kMissKey;
    return;
  }
  // the real members of the group (the rows past C are zero in wald_sc)
  const int n_mem = min(group, n_clusters - sc * group);
  if (tid < n_mem) members[tid] = sc * group + tid;
  __syncthreads();
  const rt2::Ray r = rt2::load_ray(rays8, ray);
  const bool active = r.tx > r.tn;

  rt2::ClusterRing cr{ring, slot_lanes, coeffs, lane_count, members, n_mem,
                      s_pad};
  cr.prime();
  int best = kMissKey;
  for (int m = 0; m < n_mem; ++m) {
    cp_async_wait<kRing - 2>();  // this thread's copies of member m
    // member m is in its slot, every thread is done with member m - 1's
    __syncthreads();
    cr.refill(m);
    if (!active) continue;
    const float4* tile = cr.tile(m);
    const int lanes = cr.lanes(m);
    const int s0 = m * s_pad;
#pragma unroll 4
    for (int l = 0; l < lanes; ++l) {
      float t;
      const bool hit = rt2::wald_lane_test(r, tile[l * kChunks + 0],
                                           tile[l * kChunks + 1],
                                           tile[l * kChunks + 2], t);
      const int key = (__float_as_int(t) & ~slot_mask) | (s0 + l);
      if (hit && t < r.tx) best = min(best, key);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  keys[ray] = best;
}

}  // namespace

extern "C" {

// rays8 [n_blocks*128, 8] f32 (ox oy oz dx dy dz t_min t_max) in pair
// order; block_sc, block_live [n_blocks] i32; coeffs [n_clusters, s_pad,
// 12] f32 lane-major and lane_count [n_clusters] i32, the walk tables' lanes
// (ops/cuda_traverse.py::walk_lanes), n_sc = ceil(n_clusters / group);
// keys [n_blocks*128] i32 (out). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int rt2_pair_sweep(const float* rays8, const int* block_sc,
                   const int* block_live, const float* coeffs,
                   const int* lane_count, int* keys, int n_blocks, int n_sc,
                   int n_clusters, int group, int s_pad, int slot_mask,
                   void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_sc <= 0 || group < 1 || group > kMaxPairGroup || s_pad <= 0 ||
      group * s_pad > kMaxLanes || slot_mask < group * s_pad - 1 ||
      n_clusters <= (n_sc - 1) * group || n_clusters > n_sc * group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = rt2::ring_bytes(s_pad);
  cudaError_t err = cudaFuncSetAttribute(
      pair_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_sweep_kernel<<<n_blocks, kPairP, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      rays8, block_sc, block_live, reinterpret_cast<const float4*>(coeffs),
      lane_count, keys, n_sc, n_clusters, group, s_pad, slot_mask);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM at s_pad lanes a cluster, threads per
// block, registers per thread, shared bytes per block. Returns a
// cudaError_t (0 on success).
int rt2_pair_sweep_occupancy(int s_pad, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, pair_sweep_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = rt2::ring_bytes(s_pad);
  err = cudaFuncSetAttribute(pair_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pair_sweep_kernel, kPairP, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kPairP;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}

}  // extern "C"
