// The closest-hit walk's winner decode for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes with XLA ops
// (raytracer2_tpu/ops/pallas_traverse.py:1846-1884, one _tri_meta row
// gather and the 12-FMA re-evaluation of the winner's (t, u, v)). The
// port's plain version of that decode, ops/cuda_traverse.py::
// hit_decode_reference (_decode over _unsort), is a chain of some 370
// small torch launches a trace, most of them ops/wald.py::fma's float64
// emulation of a fused multiply-add; this kernel does the same in one
// launch and needs no float64.
//
// One thread per ray row i of the walk's (bundle) order: it reads the
// winner code code[i] and its caller row dst = perm[i] (dst = i without a
// permutation: presorted pixel tiles, the pair sweep), gathers the 64-byte
// meta row of the code (row 0 for MISS_CODE) as four 16-byte loads and
// the caller's origin, direction and t_max at dst, and writes the six
// HitRecord fields at dst: the un-sort scatter and the decode in one pass,
// so the codes never round-trip through memory in caller order.
//
// The meta row (cuda_traverse.tri_meta): [0:12] the triangle's Wald
// coefficients as f32 bits in the order k*3 + c (input k: x, y, z, bias;
// output c: u, v, z), [12:15] (triangle, geometry, primitive).
//
// Bit equality with the plain version: each affine is
//   fma(w[r+6], x2, fma(w[r], x0, w[r+3] * x1))
// rounded as ops/wald.py::fma rounds it (once, as __fmaf_rn), the bias add
// and the product w[r+3] * x1 on their own (--fmad=false contracts
// nothing), t = -op_z / (dzv == 0 ? 1 : dzv) an IEEE division (no fast
// math), u and v fma(t, dp, op). The miss rule is the plain version's: a
// code of MISS_CODE reads as triangle -1 (geometry -1, primitive 0), and
// a row whose triangle is negative (a miss, or a padding lane) gives t =
// t_max, u = v = 0, geometry INVALID_INDEX (0xFFFFFFFF in int64) and
// primitive 0, its triangle as read. A code outside the table other than
// MISS_CODE traps, as a torch gather out of range asserts on the device.
//
// What bounds it: bytes. A ray reads 104 (code 4, perm 8, meta 64, origin
// and direction 24, t_max 4) and writes 32 (t, u, v, geometry, primitive,
// triangle): ~136 B, 282 MB on a 2,073,600-ray batch, ~0.08 ms at 3.35
// TB/s; the arithmetic (8 FMAs, 9 FMULs and FADDs, a division) is far
// below it. The caller-order reads and writes land where perm sends them,
// a sector a field; at the reference frame's 262,144 rays the launch's
// own latency is most of its time. What it removes is the host's work:
// ~370 dispatches a trace.

#include <cuda_runtime.h>

namespace {

constexpr int kMissCode = 0x7FFFFFFF;
constexpr long long kInvalidIndex = 0xFFFFFFFFLL;
constexpr int kThreads = 256;

// ((w[r] x0 + w[r+3] x1) + w[r+6] x2) as XLA's CPU backend contracts the
// JAX package's affine, and ops/wald.py::fma rounds it
__device__ __forceinline__ float affine(const float* w, int r, float x0,
                                        float x1, float x2) {
  return __fmaf_rn(w[r + 6], x2, __fmaf_rn(w[r], x0, w[r + 3] * x1));
}

__global__ void __launch_bounds__(kThreads)
    hit_decode_kernel(const int* __restrict__ code,
                      const long long* __restrict__ perm,
                      const int4* __restrict__ meta, long long n_rows,
                      const float* __restrict__ origins,
                      const float* __restrict__ directions,
                      const float* __restrict__ t_max, float* __restrict__ t,
                      float* __restrict__ u, float* __restrict__ v,
                      long long* __restrict__ geometry,
                      long long* __restrict__ primitive,
                      int* __restrict__ triangle, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = code[i];
  const bool missed = c == kMissCode;
  if (!missed && (c < 0 || c >= n_rows)) __trap();
  const long long dst = perm != nullptr ? perm[i] : i;
  const int4* row = meta + 4LL * (missed ? 0 : c);
  const int4 m0 = row[0], m1 = row[1], m2 = row[2], m3 = row[3];
  const float w[12] = {
      __int_as_float(m0.x), __int_as_float(m0.y), __int_as_float(m0.z),
      __int_as_float(m0.w), __int_as_float(m1.x), __int_as_float(m1.y),
      __int_as_float(m1.z), __int_as_float(m1.w), __int_as_float(m2.x),
      __int_as_float(m2.y), __int_as_float(m2.z), __int_as_float(m2.w)};
  const int tri = missed ? -1 : m3.x;
  const int geom = missed ? -1 : m3.y;
  const int prim = missed ? 0 : m3.z;

  const float* o = origins + 3 * dst;
  const float* d = directions + 3 * dst;
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = d[0], dy = d[1], dz = d[2];
  const float op_u = affine(w, 0, ox, oy, oz) + w[9];
  const float op_v = affine(w, 1, ox, oy, oz) + w[10];
  const float op_z = affine(w, 2, ox, oy, oz) + w[11];
  const float dp_u = affine(w, 0, dx, dy, dz);
  const float dp_v = affine(w, 1, dx, dy, dz);
  const float dzv = affine(w, 2, dx, dy, dz);
  const float tt = -op_z / (dzv == 0.0f ? 1.0f : dzv);

  const bool miss = tri < 0;
  t[dst] = miss ? t_max[dst] : tt;
  u[dst] = miss ? 0.0f : __fmaf_rn(tt, dp_u, op_u);
  v[dst] = miss ? 0.0f : __fmaf_rn(tt, dp_v, op_v);
  geometry[dst] = miss ? kInvalidIndex : static_cast<long long>(geom);
  primitive[dst] = miss ? 0LL : static_cast<long long>(prim);
  triangle[dst] = tri;
}

}  // namespace

extern "C" {

// code [n] i32 winner codes in the walk's order, perm [n] i64 (walk row ->
// caller row) or null for the identity, meta [n_rows, 16] i32 (16-byte
// aligned), origins and directions [n, 3] f32 and t_max [n] f32 in the
// caller's order; writes t, u, v [n] f32, geometry and primitive [n] i64,
// triangle [n] i32 in the caller's order. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int rt2_hit_decode(const int* code, const long long* perm, const int* meta,
                   long long n_rows, const float* origins,
                   const float* directions, const float* t_max, float* t,
                   float* u, float* v, long long* geometry,
                   long long* primitive, int* triangle, int n,
                   void* stream) {
  if (n <= 0) return 0;
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  hit_decode_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      code, perm, reinterpret_cast<const int4*>(meta), n_rows, origins,
      directions, t_max, t, u, v, geometry, primitive, triangle, n);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM, threads per block, registers per
// thread, shared bytes per block. Returns a cudaError_t (0 on success).
int rt2_hit_decode_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, hit_decode_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, hit_decode_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

}  // extern "C"
