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
// Layout on this card:
// - B3: one thread per ray, 256 per block; the boxes pass through shared
//   memory in tiles of kBoxTile, six floats each as six rows, and every
//   thread reads the same box at the same time (a broadcast). Each thread
//   keeps (best_e, best_i) and replaces them only on a strictly smaller e.
// - B4: one block per bundle; its P rays are staged once into shared memory
//   as (o, inv, t_min, t_max), and the threads stride over the C boxes, each
//   taking the min over the P rays of its box's e (the rays are broadcasts)
//   and writing it at out[b, c], coalesced along C.
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
// at the card's 67 TFLOP/s. The bytes (rays, boxes, the
// [N] i32 or [B, C] f32 output) are far below that. Later work: keep several
// boxes' planes in registers per thread, and split B4's rays across warps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBoxTile = 512;   // boxes per shared-memory tile (12 KB)
constexpr int kMaxBundle = 256;
constexpr float kEps = 1e-12f;

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

// boxes: [6, c] f32, rows lo.x lo.y lo.z hi.x hi.y hi.z
__global__ void __launch_bounds__(kThreads)
nearest_box_kernel(const float* __restrict__ rays8,
                   const float* __restrict__ boxes, int* __restrict__ out,
                   int n, int c) {
  __shared__ float tile[6][kBoxTile];
  const long long ray = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const bool in_batch = ray < n;
  SlabRay r{};
  if (in_batch) r = load_slab_ray(rays8, ray);
  // a ray with t_max < 0 (or NaN) misses every box: it skips the tests
  const bool live = in_batch && r.tx >= 0.0f;
  float best_e = INFINITY;
  int best_i = c;
  for (int c0 = 0; c0 < c; c0 += kBoxTile) {
    const int nb = min(kBoxTile, c - c0);
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < 6 * nb; i += kThreads) {
      const int row = i / nb;
      const int j = i - row * nb;
      tile[row][j] = boxes[static_cast<long long>(row) * c + c0 + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nb; ++j) {
      const float e = entry(r, tile[0][j], tile[1][j], tile[2][j],
                            tile[3][j], tile[4][j], tile[5][j]);
      if (e < best_e) {  // strict: the first index keeps a tie
        best_e = e;
        best_i = c0 + j;
      }
    }
  }
  if (in_batch) out[ray] = best_i;
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
  const int blocks = (n + kThreads - 1) / kThreads;
  nearest_box_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(rays8, boxes, out,
                                                            n, c);
  return static_cast<int>(cudaGetLastError());
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
