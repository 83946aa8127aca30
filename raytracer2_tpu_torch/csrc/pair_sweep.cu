// Pair sweep of the pair engine for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracer2_tpu/ops/pallas_pairs.py::_pair_kernel
// (_sweep_pairs). What it computes is unchanged: the (ray, supercluster)
// pairs come binned by supercluster into blocks of 128 rays, and each block
// tests its rays against every lane of its supercluster's Wald block
// [16, W] (W = group * S_pad, the group's clusters side by side). Per ray it
// keeps the min over the lanes of
//     key = (bits(t) & ~slot_mask) | lane   where the lane hits,
// MISS_KEY = 0x7F000000 where none does; a lane hits when |d'_z| > 1e-12,
// u >= 0, v >= 0, u + v <= 1 and t_min < t < t_max (both ends open: the
// walks test only t > t_min). A dead block (block_live == 0) writes MISS_KEY
// for all its rays, and so does a block whose supercluster id is out of
// range. Dead pairs inside a live block carry t_max = -1 and never hit.
//
// Layout on this card. The TPU kernel reads its block's supercluster id by
// scalar prefetch and lets the pipeline skip re-fetching the Wald block for
// consecutive blocks of one supercluster; here a block reads its own
// block_sc[i], and L2 gives that reuse (192 superclusters x 96 KB of rows on
// the 260k-triangle ladder scene, inside the 50 MB L2):
// - one block of 128 threads per pair block, one thread per ray, the ray
//   row read once;
// - the supercluster's 12 used Wald rows pass through shared memory in tiles
//   of kLaneTile lanes (12 x 512 floats = 24 KB, under the 48 KB static
//   limit), staged cooperatively and coalesced; every thread reads the same
//   lane at the same time (a broadcast);
// - each thread keeps a running min of its int key, exact in any order; a
//   ray whose segment is empty (t_max <= t_min, or NaN) tests nothing.
//
// What bounds it: the FP32 operations of the Wald test, 45 per (live pair
// ray, real-triangle lane): 20 multiplies, 18 adds, one divide and 6
// compares. The bytes (the [tp, 8] pair rows, the keys, the Wald rows of
// each supercluster once) are two orders of magnitude below. The affines
// are written unfused, in the order of _intersect_block (walk_common.cuh);
// with --fmad=false and an IEEE divide the kernel agrees bit for bit with
// the plain torch version (ops/cuda_pairs.py::pair_sweep_reference).
// Later work: skip a supercluster's zero lanes, stage with cp.async behind
// the compute, and take the affines to the tensor cores.

#include "walk_common.cuh"

namespace {

using rt2::kCoeffRows;
using rt2::kWaldRows;

constexpr int kPairP = 128;      // rays per pair block
constexpr int kLaneTile = 512;   // lanes per shared-memory tile
constexpr int kMaxLanes = 2048;  // W <= 2048: the lane rides in 11 key bits
constexpr int kMissKey = 0x7F000000;

__global__ void __launch_bounds__(kPairP)
pair_sweep_kernel(const float* __restrict__ rays8,
                  const int* __restrict__ block_sc,
                  const int* __restrict__ block_live,
                  const float* __restrict__ wald_sc,
                  int* __restrict__ keys, int n_sc, int w_lanes,
                  int slot_mask) {
  __shared__ float tile[kCoeffRows * kLaneTile];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(i) * kPairP + tid;
  const int sc = block_sc[i];
  if (block_live[i] == 0 || sc < 0 || sc >= n_sc) {  // uniform per block
    keys[ray] = kMissKey;
    return;
  }
  const rt2::Ray r = rt2::load_ray(rays8, ray);
  const bool active = r.tx > r.tn;
  const float* rows = wald_sc + static_cast<long long>(sc) * kWaldRows *
                                    w_lanes;
  int best = kMissKey;
  for (int l0 = 0; l0 < w_lanes; l0 += kLaneTile) {
    const int nl = min(kLaneTile, w_lanes - l0);
    __syncthreads();  // the previous tile's reads are done
    for (int idx = tid; idx < kCoeffRows * nl; idx += kPairP) {
      const int row = idx / nl;
      const int lane = idx - row * nl;
      tile[row * kLaneTile + lane] = rows[row * w_lanes + l0 + lane];
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < nl; ++s) {
      float t;
      if (rt2::wald_test(r, tile, s, kLaneTile, t) && t < r.tx) {
        const int key = (__float_as_int(t) & ~slot_mask) | (l0 + s);
        best = key < best ? key : best;
      }
    }
  }
  keys[ray] = best;
}

}  // namespace

extern "C" {

// rays8 [n_blocks*128, 8] f32 (ox oy oz dx dy dz t_min t_max) in pair
// order; block_sc, block_live [n_blocks] i32; wald_sc [n_sc, 16, w_lanes]
// f32; keys [n_blocks*128] i32 (out). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int rt2_pair_sweep(const float* rays8, const int* block_sc,
                   const int* block_live, const float* wald_sc, int* keys,
                   int n_blocks, int n_sc, int w_lanes, int slot_mask,
                   void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_sc <= 0 || w_lanes <= 0 || w_lanes > kMaxLanes ||
      slot_mask < w_lanes - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pair_sweep_kernel<<<n_blocks, kPairP, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rays8, block_sc, block_live, wald_sc, keys, n_sc, w_lanes, slot_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
