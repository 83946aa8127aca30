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
// passes).
//
// Layout on this card:
// - one thread block per bundle, one thread per ray (P = 128 or 256);
// - each step stages the `group` candidates' Wald rows (12 x S_pad floats
//   per cluster: row k*3+c holds input k = x, y, z, bias of output
//   c = u, v, z) from global into shared memory, cooperatively and
//   coalesced, then every thread tests its ray against all group*S_pad
//   lanes, reading each coefficient as a shared-memory broadcast;
// - before each step the block takes the max over its rays of
//   float(best_key | SLOT_MASK) and stops once the next candidate's entry
//   distance exceeds it (the TPU kernel's conservative early exit; a NaN in
//   any lane ends the walk, as the TPU's NaN-propagating max does).
//
// What bounds it: the FP32 lane work of the Wald test (18 multiplies, 12
// adds, one IEEE divide and five compares per ray and triangle), then the
// L2 traffic of re-staging the Wald rows for every bundle that visits a
// cluster (6 KB per cluster per visit; the rows read are 19 MB for the
// 3,072 clusters of a 260k-triangle scene, inside the 50 MB L2). The divide is a true IEEE divide and
// no multiply-add is fused (--fmad=false), so the kernel agrees bit for bit
// with the plain torch version in ops/cuda_traverse.py. Later work: stage
// with TMA/cp.async behind the compute, exit per warp instead of per block,
// and take the affines to wgmma.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSlotMask = (1 << 10) - 1;
constexpr int kMissCode = 0x7FFFFFFF;
constexpr int kWaldRows = 16;   // rows per cluster in the table (12 used)
constexpr int kCoeffRows = 12;
constexpr int kMaxGroup = 8;    // group * S_pad <= 1 << 10

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void walk_closest_kernel(const float* __restrict__ rays8,
                                    const int* __restrict__ cand_idx,
                                    const float* __restrict__ cand_t,
                                    const int* __restrict__ cand_count,
                                    const float* __restrict__ wald,
                                    int* __restrict__ out_code,
                                    int k, int s_pad, int group) {
  extern __shared__ float smem[];
  const int w_lanes = group * s_pad;
  float* tile = smem;                            // [12][w_lanes]
  float* warp_worst = smem + kCoeffRows * w_lanes;  // [32]
  __shared__ int group_ci[kMaxGroup];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = blockDim.x;
  const int n_warps = (p + 31) >> 5;
  const long long ray = static_cast<long long>(b) * p + tid;

  const float* r = rays8 + ray * 8;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  const float tn = r[6], tx = r[7];

  // init from t_max: IEEE bits are monotone for t >= 0, dead rays
  // (t_max < 0) get a negative key no hit can beat; the low bits are set
  // so a hit at exactly t_max still wins
  int best_key = (__float_as_int(tx) & ~kSlotMask) | kSlotMask;
  int best_code = kMissCode;

  const int n_cand = cand_count[b];
  const int* ci_row = cand_idx + static_cast<long long>(b) * k;
  const float* ct_row = cand_t + static_cast<long long>(b) * k;

  for (int k0 = 0; k0 < n_cand; k0 += group) {
    // early exit; the barrier also ends the previous step's tile reads
    const float worst_mine = __int_as_float(best_key | kSlotMask);
    const int any_nan = __syncthreads_or(isnan(worst_mine));
    const float wm = warp_max(worst_mine);
    if ((tid & 31) == 0) warp_worst[tid >> 5] = wm;
    __syncthreads();
    float worst = warp_worst[0];
    for (int i = 1; i < n_warps; ++i) worst = fmaxf(worst, warp_worst[i]);
    if (any_nan || !(ct_row[k0] <= worst)) break;

    // stage the step's Wald rows: i runs over (g, row, lane) in the
    // table's own order so neighbouring threads read neighbouring words
    const int n_grp = min(group, n_cand - k0);
    if (tid < n_grp) group_ci[tid] = ci_row[k0 + tid];
    const int per_cluster = kCoeffRows * s_pad;
    for (int i = tid; i < n_grp * per_cluster; i += p) {
      const int g = i / per_cluster;
      const int rem = i - g * per_cluster;
      const int row = rem / s_pad;
      const int lane = rem - row * s_pad;
      const long long ci = ci_row[k0 + g];
      tile[row * w_lanes + g * s_pad + lane] =
          wald[(ci * kWaldRows + row) * s_pad + lane];
    }
    __syncthreads();

    // group members past n_cand were never staged: the lane loop stops
    // at the live ones (the TPU kernel masks them)
    const int lanes = n_grp * s_pad;
    for (int s = 0; s < lanes; ++s) {
      const float* w = tile + s;
      const float w0 = w[0 * w_lanes], w1 = w[1 * w_lanes];
      const float w2 = w[2 * w_lanes], w3 = w[3 * w_lanes];
      const float w4 = w[4 * w_lanes], w5 = w[5 * w_lanes];
      const float w6 = w[6 * w_lanes], w7 = w[7 * w_lanes];
      const float w8 = w[8 * w_lanes], w9 = w[9 * w_lanes];
      const float w10 = w[10 * w_lanes], w11 = w[11 * w_lanes];
      const float op_u = ((ox * w0 + oy * w3) + oz * w6) + w9;
      const float op_v = ((ox * w1 + oy * w4) + oz * w7) + w10;
      const float op_z = ((ox * w2 + oy * w5) + oz * w8) + w11;
      const float dp_u = (dx * w0 + dy * w3) + dz * w6;
      const float dp_v = (dx * w1 + dy * w4) + dz * w7;
      const float dp_z = (dx * w2 + dy * w5) + dz * w8;
      const float t = -op_z / dp_z;
      const float uu = op_u + t * dp_u;
      const float vv = op_v + t * dp_v;
      if (fabsf(dp_z) > 1e-12f && uu >= 0.0f && vv >= 0.0f &&
          uu + vv <= 1.0f && t > tn) {
        const int key = (__float_as_int(t) & ~kSlotMask) | s;
        if (key < best_key) {
          const int g = s / s_pad;
          best_key = key;
          best_code = group_ci[g] * s_pad + (s - g * s_pad);
        }
      }
    }
  }
  out_code[ray] = best_code;
}

}  // namespace

extern "C" {

// rays8 [n_bundles*p, 8] f32 (ox oy oz dx dy dz t_min t_max), cand_idx and
// cand_t [n_bundles, k] (i32 / f32, nearest first), cand_count [n_bundles]
// i32, wald [C, 16, s_pad] f32, out_code [n_bundles*p] i32. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int rt2_walk_closest(const float* rays8, const int* cand_idx,
                     const float* cand_t, const int* cand_count,
                     const float* wald, int* out_code, int n_bundles, int p,
                     int k, int s_pad, int group, void* stream) {
  if (n_bundles <= 0) return 0;
  if (p <= 0 || p > 1024 || p % 32 != 0 || group < 1 ||
      group > kMaxGroup || group * s_pad > kSlotMask + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (kCoeffRows * group * s_pad + 32);
  cudaError_t err = cudaFuncSetAttribute(
      walk_closest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_closest_kernel<<<n_bundles, p, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rays8, cand_idx, cand_t, cand_count, wald, out_code, k, s_pad, group);
  return static_cast<int>(cudaGetLastError());
}

const char* rt2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
