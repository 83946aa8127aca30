// The exact cull's two dense slab passes for Hopper (sm_90a).
//
// Replace the TPU kernels raytracer2_tpu/ops/pallas_cull.py::_key_kernel
// (nearest_box_pallas) and ::_union_kernel (bundle_union_pallas). What they
// compute is unchanged. For a ray (o, d, t_min, t_max) and a cluster box
// [bmin, bmax] the conservative entry distance is
//     ds  = |d| < 1e-12 ? +-1e-12 : d,   inv = 1 / ds   (per axis)
//     t0  = (bmin - o) * inv,  t1 = (bmax - o) * inv
//     near = max over axes of min(t0, t1),  far = min over axes of max(t0, t1)
//     e   = near <= far && far >= t_min && near <= t_max && t_max >= 0
//           ? max(near, +0) : +inf
// The t_max >= 0 test depends on the ray alone: both kernels make it once
// per ray (a ray that fails it tests no box), not once per box.
// - rt2_nearest_box (B3): per ray, the index of the box of least e, the
//   first index on ties, C where every e is +inf (the cand0 sort key's
//   dense pass);
// - rt2_bundle_union (B4): per bundle of P consecutive rays and per box, the
//   least e over the bundle's rays (the [B, C] union table that the
//   candidate ranking sorts).
//
// Bit equality with the plain torch versions (ops/cull.py): the division is
// IEEE (no --use_fast_math) and nothing is fused (--fmad=false), in the
// order the plain version writes it. min and max propagate NaN, as torch's
// minimum/maximum do (CUDA's fminf/fmaxf would drop it and turn a NaN ray
// into a hit), so a NaN ray misses every box in both. The zero of a ray
// that starts on or inside a box is always +0 (max(-0, +0) is +0 in both),
// so the union table carries no sign of zero that depends on the device.
// Padded rays (t_max = -1) and dead rays (t_max < 0) miss every box.
//
// What bounds them: the FP32 work of the slab tests, 6 subtracts, 6
// multiplies, 6 mins and maxes within the axes, 4 across them, 3 compares
// of the hit test, the clamp and the reduction compare: 27 per (live ray,
// box), ~6.4e9 tests on a 2,073,600-ray batch against 3,072 boxes, ~2.6 ms
// at the card's 67 TFLOP/s, a rate that counts an FMA as two operations:
// 13.5 instruction issues a test. None of these is an FMA, so an exact
// kernel that issues ~28 instructions a test stays under ~48% of that
// bound. The bytes (rays, boxes, the [N] i32 or [B, C] f32 output) are far
// below it.
//
// B3 (redesigned for this card): kNearThreads threads a block, each
// holding kRaysPerThread rays (coalesced: ray q of thread t is t + q *
// kNearThreads of the block's run), so one box read from shared memory
// serves four rays. The boxes pass through shared memory in tiles of
// kNearTile, each box as two 16-byte vectors (lo, hi; two broadcast loads),
// transposed from the [6, C] rows while staging. Per ray the kernel keeps
// the index of the least entry and `lim`: nextafter(t_max, +inf) until a
// box is taken, then that box's entry. A box is taken only on an entry
// strictly below `lim` (the first index keeps a tie), and for a live ray
// (t_max >= 0) "near <= t_max and max(near, 0) < best" is "max(near, 0) <
// lim", so the t_max compare needs no instruction of its own. A ray with
// t_max < 0 or NaN gets lim = -inf and never takes a box.
// The finite fast path: where a thread's live rays have finite o and d and
// the tile's boxes are finite (the cluster boxes are, by construction:
// empty clusters get +-1e30 boxes, ops/cluster.py), every slab distance is
// a number: |inv| lies in (0, 1e12] (safe_inv), so (b - o) * inv is finite
// or, past FLT_MAX, an infinity, never 0 * inf. Then the plain fminf/fmaxf
// give the NaN-propagating min/max's values, differing at most in the sign
// of a zero, and a zero's sign reaches only compares (sign-blind) and the
// clamp max(near, 0) (a zero either way); the output is an index, so no
// bit changes. Other threads, and tiles with a non-finite box, run the
// NaN-propagating entry() of B4. What bounds B3 now is instruction issue:
// per box and four rays the fast loop is 24 FADD, 24 FMUL, 44 FMNMX, 12
// FSETP and 8 selects, ~30 a test. Tried and dropped: sorting a block's
// rays by octant so that each axis' near and far corners are chosen once
// per box (the loop falls to ~25 a test) measured slower, since the
// threads at a class boundary take the min/max loop and their warps run
// both loops.
//
// B4 (the first port's design, still on entry() with nan_min / nan_max):
// one block per bundle; its P rays are staged once into shared memory as
// (o, inv, t_min, t_max), and the threads stride over the C boxes, each
// taking the min over the P rays of its box's e (the rays are broadcasts)
// and writing it at out[b, c], coalesced along C. Later work: B3's finite
// fast path and several boxes per thread, and B4's rays split across warps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBundle = 256;
constexpr float kEps = 1e-12f;
constexpr int kNearThreads = 128;
constexpr int kRaysPerThread = 4;
constexpr int kNearRays = kNearThreads * kRaysPerThread;  // per block
constexpr int kNearTile = 256;  // boxes per shared-memory tile (8 KB)
constexpr int kNearMinBlocks = 8;  // per SM: <= 64 registers a thread

// torch.minimum / torch.maximum on float32: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff)
                                : (a < b ? a : b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff)
                                : (a > b ? a : b);
}

__device__ __forceinline__ float safe_inv(float d) {
  const float ds = fabsf(d) < kEps ? (d >= 0.0f ? kEps : -kEps) : d;
  return 1.0f / ds;
}

struct SlabRay {
  float ox, oy, oz, ix, iy, iz, tn, tx;
};

__device__ __forceinline__ SlabRay load_slab_ray(const float* rays8,
                                                 long long ray) {
  const float* r = rays8 + ray * 8;
  return SlabRay{r[0], r[1], r[2], safe_inv(r[3]), safe_inv(r[4]),
                 safe_inv(r[5]), r[6], r[7]};
}

// The conservative entry distance of a live ray r (t_max >= 0, tested by
// the caller) into box (lo, hi), in the plain version's order: x, then y,
// then z.
__device__ __forceinline__ float entry(const SlabRay& r, float lx, float ly,
                                       float lz, float hx, float hy,
                                       float hz) {
  const float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  float near = nan_min(t0x, t1x), far = nan_max(t0x, t1x);
  const float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  near = nan_max(near, nan_min(t0y, t1y));
  far = nan_min(far, nan_max(t0y, t1y));
  const float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  near = nan_max(near, nan_min(t0z, t1z));
  far = nan_min(far, nan_max(t0z, t1z));
  const bool hit = near <= far && far >= r.tn && near <= r.tx;
  return hit ? (near > 0.0f ? near : 0.0f) : INFINITY;
}

// B3's fast path: the slab test of a live ray with finite o and d against a
// finite box (lo, hi), taking it (lim, best = e, index) when its entry is
// below lim. Same order as entry(); see the header for why fminf/fmaxf and
// the folded t_max compare give entry()'s index.
__device__ __forceinline__ void take_if_nearer(
    float ox, float oy, float oz, float ix, float iy, float iz, float tn,
    const float4& lo, const float4& hi, int index, float& lim, int& best) {
  const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  float near = fminf(t0x, t1x), far = fmaxf(t0x, t1x);
  const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  near = fmaxf(near, fminf(t0y, t1y));
  far = fminf(far, fmaxf(t0y, t1y));
  const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  near = fmaxf(near, fminf(t0z, t1z));
  far = fminf(far, fmaxf(t0z, t1z));
  const float e = fmaxf(near, 0.0f);
  if (near <= far && far >= tn && e < lim) {
    lim = e;
    best = index;
  }
}

// boxes: [6, c] f32, rows lo.x lo.y lo.z hi.x hi.y hi.z
__global__ void __launch_bounds__(kNearThreads, kNearMinBlocks)
nearest_box_kernel(const float* __restrict__ rays8,
                   const float* __restrict__ boxes, int* __restrict__ out,
                   int n, int c) {
  __shared__ float4 tile[kNearTile][2];  // lo (x y z -), hi (x y z -)
  const long long first = static_cast<long long>(blockIdx.x) * kNearRays +
                          threadIdx.x;
  SlabRay r[kRaysPerThread];
  float lim[kRaysPerThread];
  int best[kRaysPerThread];
  bool fast = true;  // every live ray of this thread has finite o and d
  bool any_live = false;
#pragma unroll
  for (int q = 0; q < kRaysPerThread; ++q) {
    const long long ray = first + q * kNearThreads;
    r[q] = SlabRay{};
    bool live = false, finite = true;
    if (ray < n) {
      const float* p = rays8 + ray * 8;
      r[q] = SlabRay{p[0], p[1], p[2], safe_inv(p[3]), safe_inv(p[4]),
                     safe_inv(p[5]), p[6], p[7]};
      live = r[q].tx >= 0.0f;  // false for t_max < 0 or NaN
#pragma unroll
      for (int a = 0; a < 6; ++a) finite = finite && isfinite(p[a]);
    }
    lim[q] = live ? nextafterf(r[q].tx, INFINITY) : -INFINITY;
    best[q] = c;
    fast = fast && (finite || !live);
    any_live = any_live || live;
  }
  for (int c0 = 0; c0 < c; c0 += kNearTile) {
    const int nb = min(kNearTile, c - c0);
    __syncthreads();  // the previous tile's reads are done
    bool finite_boxes = true;
    for (int j = threadIdx.x; j < nb; j += kNearThreads) {
      const float* b = boxes + c0 + j;
      const float lx = b[0], ly = b[c], lz = b[2 * c];
      const float hx = b[3 * c], hy = b[4 * c], hz = b[5 * c];
      finite_boxes = finite_boxes && isfinite(lx) && isfinite(ly) &&
                     isfinite(lz) && isfinite(hx) && isfinite(hy) &&
                     isfinite(hz);
      tile[j][0] = make_float4(lx, ly, lz, 0.0f);
      tile[j][1] = make_float4(hx, hy, hz, 0.0f);
    }
    const bool tile_finite = __syncthreads_and(finite_boxes);
    if (!any_live) continue;
    if (fast && tile_finite) {
      for (int j = 0; j < nb; ++j) {
        const float4 lo = tile[j][0], hi = tile[j][1];
#pragma unroll
        for (int q = 0; q < kRaysPerThread; ++q) {
          take_if_nearer(r[q].ox, r[q].oy, r[q].oz, r[q].ix, r[q].iy,
                         r[q].iz, r[q].tn, lo, hi, c0 + j, lim[q], best[q]);
        }
      }
    } else {
      for (int j = 0; j < nb; ++j) {
        const float4 lo = tile[j][0], hi = tile[j][1];
#pragma unroll
        for (int q = 0; q < kRaysPerThread; ++q) {
          // entry() is +inf on a miss or a NaN ray, never below lim = -inf
          const float e = entry(r[q], lo.x, lo.y, lo.z, hi.x, hi.y, hi.z);
          if (e < lim[q]) {
            lim[q] = e;
            best[q] = c0 + j;
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRaysPerThread; ++q) {
    const long long ray = first + q * kNearThreads;
    if (ray < n) out[ray] = best[q];
  }
}

__global__ void __launch_bounds__(kThreads)
bundle_union_kernel(const float* __restrict__ rays8,
                    const float* __restrict__ boxes,
                    float* __restrict__ out, int p, int c) {
  __shared__ SlabRay rays[kMaxBundle];
  __shared__ int n_live;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  // stage the bundle's live rays (t_max >= 0); a dead ray contributes +inf
  // to every box and drops out. The atomic slot order is arbitrary, which
  // the min does not see: its operands are never NaN and never -0
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const SlabRay r = load_slab_ray(rays8, static_cast<long long>(b) * p + i);
    if (r.tx >= 0.0f) rays[atomicAdd(&n_live, 1)] = r;
  }
  __syncthreads();
  const int m = n_live;
  float* row = out + static_cast<long long>(b) * c;
  for (int j = threadIdx.x; j < c; j += kThreads) {
    const float lx = boxes[j], ly = boxes[c + j], lz = boxes[2 * c + j];
    const float hx = boxes[3 * c + j], hy = boxes[4 * c + j],
                hz = boxes[5 * c + j];
    float best = INFINITY;
    for (int i = 0; i < m; ++i) {
      const float e = entry(rays[i], lx, ly, lz, hx, hy, hz);
      best = e < best ? e : best;
    }
    row[j] = best;
  }
}

}  // namespace

extern "C" {

// rays8 [n, 8] f32 (ox oy oz dx dy dz t_min t_max), boxes [6, c] f32,
// out [n] i32. Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int rt2_nearest_box(const float* rays8, const float* boxes, int* out, int n,
                    int c, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kNearRays - 1) / kNearRays;
  nearest_box_kernel<<<blocks, kNearThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(rays8, boxes, out,
                                                            n, c);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM of rt2_nearest_box's kernel, threads per
// block, registers per thread, shared bytes per block. Returns a
// cudaError_t (0 on success).
int rt2_nearest_box_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, nearest_box_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, nearest_box_kernel, kNearThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kNearThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// rays8 [n_bundles * p, 8] f32, boxes [6, c] f32, out [n_bundles, c] f32.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int rt2_bundle_union(const float* rays8, const float* boxes, float* out,
                     int n_bundles, int p, int c, void* stream) {
  if (n_bundles <= 0) return 0;
  if (p <= 0 || p > kMaxBundle || c <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bundle_union_kernel<<<n_bundles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(rays8, boxes,
                                                             out, p, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
