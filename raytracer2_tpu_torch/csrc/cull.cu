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
// bound (B4's fast loop needs fewer, ~20 a test, by choosing the slab
// corners per octant instead of taking their min and max). The bytes
// (rays, boxes, the [N] i32 or [B, C] f32 output) are far below it.
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
// NaN-propagating entry(). What bounds B3 now is instruction issue:
// per box and four rays the fast loop is 24 FADD, 24 FMUL, 44 FMNMX, 12
// FSETP and 8 selects, ~30 a test. Tried and dropped: sorting a block's
// rays by octant so that each axis' near and far corners are chosen once
// per box (the loop falls to ~25 a test) measured slower, since the
// threads at a class boundary take the min/max loop and their warps run
// both loops.
//
// B4 (redesigned for this card): what held the first design back was
// entry()'s NaN-propagating min and max (an isnan-isnan-compare-select
// chain each, ten a test) and one box per thread, so each ray read from
// shared memory served one test. Now each block takes one bundle and a
// tile of kUnionTile boxes: each of its kUnionThreads threads holds
// kUnionBoxes boxes in registers (box c0 + k * kUnionThreads + t, so loads
// and the output row stay coalesced along C), and the bundle's rays stream
// past them as two 16-byte broadcasts, (o, t_min) and (inv, t_max), each
// serving kUnionBoxes independent tests. 128 threads, 8 blocks per SM at
// <= 64 registers; 6 tiles cover C = 3,072, so a 16,200-bundle batch is
// 97,200 blocks.
// - The lists. Staging sorts the bundle's live rays into nine lists: the
//   rays whose six o and d floats are finite, by octant (the signs of
//   inv), then the rest. The rays are broadcasts, so a list is the same
//   for every thread of a block and a warp never runs two loops (B3's
//   per-thread rays could not be split so). A tile whose boxes are all
//   finite (the cluster boxes are) sorts each box's corners per axis; a
//   tile with a non-finite box runs entry() for every ray.
// - The fast loop, per octant. For a finite ray and a finite box the slab
//   distances are numbers (B3's argument above). inv is nonzero; where
//   inv_a > 0, lo <= hi gives (lo - o) * inv <= (hi - o) * inv (rounding
//   is monotone), and where inv_a < 0 the reverse: the min of the pair is
//   the near corner's, chosen at compile time per octant, so the per-axis
//   min and max cost nothing. {t0, t1} is the same pair for the sorted box
//   (min(t0, t1) and max(t0, t1) are symmetric), so an empty cluster's
//   inverted +-1e30 box gets the plain version's result too. Per test: 6
//   FADD, 6 FMUL, 4 FMNMX across the axes, 3 compares and one min, ~20
//   instructions. Their rate is what bounds B4 now: it runs at ~46% of
//   the bound on a flagship bounce batch (PERF.md).
// - The clamp leaves the loop. The loop keeps the least raw near over the
//   hits (fminf: its operands are never NaN, so the order of rays and
//   lists does not matter), and the store writes best > 0 ? best : +0:
//   max(., 0) is monotone, so that is the least max(near, +0), and a zero
//   of either sign, or a -inf near, leaves as +0. Not fmaxf(best, 0),
//   whose zero sign would be the instruction's choice.
// - The rest (a NaN or infinite o or d) run entry() against the same
//   registers, after the octant lists; entry() gives +0 or more, or +inf.
// - The cap (t_cap=True, bundle_union_kernel<true>; JAX's
//   _entry_exact_cap): also, per ray, the farthest exit `far` over the
//   boxes it overlaps, -inf where it overlaps none. A box tile is one
//   block's, so the max crosses blocks: each thread folds its boxes' far
//   for the ray in turn, a warp takes the max (redux.sync over the float
//   order as ints, with -0 made +0 first, so no zero's sign depends on the
//   order), one shared atomicMax a warp folds it into the bundle's row,
//   and the block's rows go out with one global atomicMax a ray into a
//   buffer the wrapper fills with the order of -inf: the same bits in any
//   order of blocks. Cost: a max per box test, a redux and an atomic per
//   ray and warp.

#include <climits>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxBundle = 256;
constexpr float kEps = 1e-12f;
constexpr int kNearThreads = 128;
constexpr int kRaysPerThread = 4;
constexpr int kNearRays = kNearThreads * kRaysPerThread;  // per block
constexpr int kNearTile = 256;  // boxes per shared-memory tile (8 KB)
constexpr int kNearMinBlocks = 8;  // per SM: <= 64 registers a thread
constexpr int kUnionThreads = 128;
constexpr int kUnionBoxes = 4;  // boxes a thread holds in registers
constexpr int kUnionTile = kUnionThreads * kUnionBoxes;  // boxes per block
constexpr int kUnionLists = 9;  // finite rays by octant, then the rest
constexpr int kUnionStage = kMaxBundle / kUnionThreads;  // rays a thread
constexpr int kUnionMinBlocks = 8;  // per SM: <= 64 registers a thread

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

struct Slab {
  float near, far;
  bool hit;
};

// The slab test of a live ray r (t_max >= 0, tested by the caller) against
// box (lo, hi), in the plain version's order: x, then y, then z.
__device__ __forceinline__ Slab slab(const SlabRay& r, float lx, float ly,
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
  return Slab{near, far, near <= far && far >= r.tn && near <= r.tx};
}

// The conservative entry distance of a live ray r into box (lo, hi).
__device__ __forceinline__ float entry(const SlabRay& r, float lx, float ly,
                                       float lz, float hx, float hy,
                                       float hz) {
  const Slab sl = slab(r, lx, ly, lz, hx, hy, hz);
  return sl.hit ? (sl.near > 0.0f ? sl.near : 0.0f) : INFINITY;
}

// The order of -inf under cap_order: where a ray's cap starts.
constexpr int kNegInfOrder = static_cast<int>(0x807FFFFFu);

// The float order of a far distance (never NaN) as an int, -0 made +0.
__device__ __forceinline__ int cap_order(float far) {
  const int bits = __float_as_int(__fadd_rn(far, 0.0f));
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

// The cap of staged ray `at`: the warp's max of the threads' folds m into
// the bundle's shared row (cap_row[ray_id[at]]).
__device__ __forceinline__ void fold_cap(float m, int at,
                                         const int* __restrict__ ray_id,
                                         int* cap_row) {
  const int w = __reduce_max_sync(0xffffffffu, cap_order(m));
  if ((threadIdx.x & 31) == 0 && w != kNegInfOrder) {
    atomicMax(&cap_row[ray_id[at]], w);
  }
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

// B4's fast loop over the finite rays of one octant (the signs of inv as
// bits x 1, y 2, z 4; set where inv < 0) against the thread's finite boxes,
// sorted per axis (lo <= hi): on axis a the near corner is lo where
// inv_a > 0 and hi where inv_a < 0, so the slab's min and max need no
// instruction (see the header). Folds each hit's raw near into best and,
// with kCap, its far into the ray's cap.
template <int kOct, bool kCap>
__device__ __forceinline__ void union_octant(
    const float4* __restrict__ ra, const float4* __restrict__ rb, int i0,
    int i1, const float (&lo)[kUnionBoxes][3],
    const float (&hi)[kUnionBoxes][3], float (&best)[kUnionBoxes],
    const int* __restrict__ ray_id, int* cap_row, int box_mask) {
  constexpr bool kNegX = kOct & 1, kNegY = kOct & 2, kNegZ = kOct & 4;
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const float4 a = ra[i];  // ox oy oz t_min
    const float4 b = rb[i];  // ix iy iz t_max
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kUnionBoxes; ++k) {
      const float nx = ((kNegX ? hi[k][0] : lo[k][0]) - a.x) * b.x;
      const float fx = ((kNegX ? lo[k][0] : hi[k][0]) - a.x) * b.x;
      const float ny = ((kNegY ? hi[k][1] : lo[k][1]) - a.y) * b.y;
      const float fy = ((kNegY ? lo[k][1] : hi[k][1]) - a.y) * b.y;
      const float nz = ((kNegZ ? hi[k][2] : lo[k][2]) - a.z) * b.z;
      const float fz = ((kNegZ ? lo[k][2] : hi[k][2]) - a.z) * b.z;
      const float near = fmaxf(fmaxf(nx, ny), nz);
      const float far = fminf(fminf(fx, fy), fz);
      if (near <= far && far >= a.w && near <= b.w) {
        best[k] = fminf(best[k], near);
        if constexpr (kCap) {
          if (box_mask >> k & 1) m = fmaxf(m, far);
        }
      }
    }
    if constexpr (kCap) fold_cap(m, i, ray_id, cap_row);
  }
}

// B4's exact loop: entry() of each staged ray in [i0, i1) against the
// thread's boxes (as given, or sorted where they are finite: entry() is
// symmetric in lo and hi on each axis, up to the sign of a zero that no
// compare sees and the clamp erases; far's value is the same too). With
// kCap, also folds each hit's far into the ray's cap.
template <bool kCap>
__device__ __forceinline__ void union_exact(
    const float4* __restrict__ ra, const float4* __restrict__ rb, int i0,
    int i1, const float (&lo)[kUnionBoxes][3],
    const float (&hi)[kUnionBoxes][3], float (&best)[kUnionBoxes],
    const int* __restrict__ ray_id, int* cap_row, int box_mask) {
  for (int i = i0; i < i1; ++i) {
    const float4 a = ra[i], b = rb[i];
    const SlabRay r{a.x, a.y, a.z, b.x, b.y, b.z, a.w, b.w};
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kUnionBoxes; ++k) {
      const Slab sl = slab(r, lo[k][0], lo[k][1], lo[k][2], hi[k][0],
                           hi[k][1], hi[k][2]);
      best[k] = fminf(best[k], sl.hit ? (sl.near > 0.0f ? sl.near : 0.0f)
                                      : INFINITY);
      if constexpr (kCap) {
        if (sl.hit && (box_mask >> k & 1)) m = fmaxf(m, sl.far);
      }
    }
    if constexpr (kCap) fold_cap(m, i, ray_id, cap_row);
  }
}

// boxes: [6, c] f32, rows lo.x lo.y lo.z hi.x hi.y hi.z. Block x takes
// bundle x / n_tiles and the kUnionTile boxes of tile x % n_tiles. kCap:
// also each ray's farthest overlapped exit into cap (cap_order ints,
// atomicMax over the blocks of its bundle).
template <bool kCap>
__global__ void __launch_bounds__(kUnionThreads, kUnionMinBlocks)
bundle_union_kernel(const float* __restrict__ rays8,
                    const float* __restrict__ boxes,
                    float* __restrict__ out, int* __restrict__ cap, int p,
                    int c, int n_tiles) {
  __shared__ float4 ray_a[kMaxBundle];  // ox oy oz t_min, by list
  __shared__ float4 ray_b[kMaxBundle];  // ix iy iz t_max
  __shared__ int list_count[kUnionLists];
  __shared__ int list_start[kUnionLists + 1];
  __shared__ int ray_id[kCap ? kMaxBundle : 1];   // staged slot -> ray
  __shared__ int cap_row[kCap ? kMaxBundle : 1];  // the bundle's caps
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_tiles;
  const int c0 = (blockIdx.x - b * n_tiles) * kUnionTile;
  if (tid < kUnionLists) list_count[tid] = 0;
  if constexpr (kCap) {
    for (int i = tid; i < p; i += kUnionThreads) cap_row[i] = kNegInfOrder;
  }

  // the thread's boxes c0 + k * kUnionThreads + tid (coalesced along C);
  // past c a zero box, finite, never stored
  float lo[kUnionBoxes][3], hi[kUnionBoxes][3];
  bool finite = true;
  int box_mask = 0;  // bit k: box k is a real box (the cap reads only those)
#pragma unroll
  for (int k = 0; k < kUnionBoxes; ++k) {
    const int j = c0 + k * kUnionThreads + tid;
    box_mask |= (j < c) << k;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[k][a] = j < c ? boxes[a * c + j] : 0.0f;
      hi[k][a] = j < c ? boxes[(3 + a) * c + j] : 0.0f;
      finite = finite && isfinite(lo[k][a]) && isfinite(hi[k][a]);
    }
  }
  __syncthreads();  // list_count is zero

  // stage the bundle's live rays (t_max >= 0; a dead ray contributes +inf
  // to every box) into nine lists: the finite rays of each octant, then the
  // rest. The atomic slot order is arbitrary, which the min does not see
  float4 sa[kUnionStage], sb[kUnionStage];
  int list[kUnionStage], slot[kUnionStage];
#pragma unroll
  for (int q = 0; q < kUnionStage; ++q) {
    const int i = tid + q * kUnionThreads;
    list[q] = -1;
    if (i < p) {
      const float* r = rays8 + (static_cast<long long>(b) * p + i) * 8;
      const float ix = safe_inv(r[3]), iy = safe_inv(r[4]),
                  iz = safe_inv(r[5]);
      sa[q] = make_float4(r[0], r[1], r[2], r[6]);
      sb[q] = make_float4(ix, iy, iz, r[7]);
      if (r[7] >= 0.0f) {  // false for t_max < 0 or NaN
        bool fin = true;
#pragma unroll
        for (int a = 0; a < 6; ++a) fin = fin && isfinite(r[a]);
        list[q] = fin ? (ix < 0.0f) | (iy < 0.0f) << 1 | (iz < 0.0f) << 2
                      : kUnionLists - 1;
        slot[q] = atomicAdd(&list_count[list[q]], 1);
      }
    }
  }
  const bool tile_finite = __syncthreads_and(finite);
  if (tid == 0) {
    int s = 0;
    for (int l = 0; l < kUnionLists; ++l) {
      list_start[l] = s;
      s += list_count[l];
    }
    list_start[kUnionLists] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kUnionStage; ++q) {
    if (list[q] >= 0) {
      const int at = list_start[list[q]] + slot[q];
      ray_a[at] = sa[q];
      ray_b[at] = sb[q];
      if constexpr (kCap) ray_id[at] = tid + q * kUnionThreads;
    }
  }
  __syncthreads();

  float best[kUnionBoxes];
#pragma unroll
  for (int k = 0; k < kUnionBoxes; ++k) best[k] = INFINITY;
  if (tile_finite) {
#pragma unroll
    for (int k = 0; k < kUnionBoxes; ++k) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float l = fminf(lo[k][a], hi[k][a]);
        hi[k][a] = fmaxf(lo[k][a], hi[k][a]);
        lo[k][a] = l;
      }
    }
    const int* st = list_start;
    union_octant<0, kCap>(ray_a, ray_b, st[0], st[1], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<1, kCap>(ray_a, ray_b, st[1], st[2], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<2, kCap>(ray_a, ray_b, st[2], st[3], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<3, kCap>(ray_a, ray_b, st[3], st[4], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<4, kCap>(ray_a, ray_b, st[4], st[5], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<5, kCap>(ray_a, ray_b, st[5], st[6], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<6, kCap>(ray_a, ray_b, st[6], st[7], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_octant<7, kCap>(ray_a, ray_b, st[7], st[8], lo, hi, best, ray_id,
                          cap_row, box_mask);
    union_exact<kCap>(ray_a, ray_b, st[8], st[9], lo, hi, best, ray_id,
                      cap_row, box_mask);
  } else {
    union_exact<kCap>(ray_a, ray_b, 0, list_start[kUnionLists], lo, hi,
                      best, ray_id, cap_row, box_mask);
  }
  float* row = out + static_cast<long long>(b) * c;
#pragma unroll
  for (int k = 0; k < kUnionBoxes; ++k) {
    const int j = c0 + k * kUnionThreads + tid;
    // max(min over rays of near, +0) is the min over rays of max(near,
    // +0), and a zero of either sign leaves as +0
    if (j < c) row[j] = best[k] > 0.0f ? best[k] : 0.0f;
  }
  if constexpr (kCap) {
    __syncthreads();  // every warp has folded its caps
    int* cap_out = cap + static_cast<long long>(b) * p;
    for (int i = tid; i < p; i += kUnionThreads) {
      if (cap_row[i] != kNegInfOrder) atomicMax(&cap_out[i], cap_row[i]);
    }
  }
}

// out[4]: resident blocks per SM of a kernel with static shared memory
// only, at `threads` a block; threads; registers per thread; shared bytes
// per block. Returns a cudaError_t (0 on success).
template <typename Kernel>
int block_occupancy(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = threads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
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
  return block_occupancy(nearest_box_kernel, kNearThreads, out);
}

// rays8 [n_bundles * p, 8] f32, boxes [6, c] f32, out [n_bundles, c] f32,
// cap [n_bundles * p] i32 filled with the order of -inf (-2139095041) by
// the caller, or null for no cap: each ray's farthest overlapped exit as a
// float order (bits >= 0 ? bits : bits ^ 0x7FFFFFFF). Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int rt2_bundle_union(const float* rays8, const float* boxes, float* out,
                     int* cap, int n_bundles, int p, int c, void* stream) {
  if (n_bundles <= 0) return 0;
  if (p <= 0 || p > kMaxBundle || c <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (c + kUnionTile - 1) / kUnionTile;
  const long long blocks = static_cast<long long>(n_bundles) * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (cap != nullptr) {
    bundle_union_kernel<true><<<static_cast<int>(blocks), kUnionThreads, 0,
                                s>>>(rays8, boxes, out, cap, p, c, n_tiles);
  } else {
    bundle_union_kernel<false><<<static_cast<int>(blocks), kUnionThreads, 0,
                                 s>>>(rays8, boxes, out, nullptr, p, c,
                                      n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM of rt2_bundle_union's kernel (cap != 0:
// the instance with the cap), threads per block, registers per thread,
// shared bytes per block. Returns a cudaError_t (0 on success).
int rt2_bundle_union_occupancy(int cap, int* out) {
  return cap ? block_occupancy(bundle_union_kernel<true>, kUnionThreads, out)
             : block_occupancy(bundle_union_kernel<false>, kUnionThreads,
                               out);
}

}  // extern "C"
