// The ReSTIR DI spatial resampling stage for Hopper (sm_90a), bias
// correction modes 0 (off), 1 (basic) and 2 (pairwise MIS).
//
// Replaces no TPU kernel: the JAX package runs the stage as XLA ops
// (raytracer2_tpu/restir/di_resampling.py::di_spatial_resampling), and the
// port's plain version, restir/di_resampling.py::
// di_spatial_resampling_plain, as some thousands of whole-image torch
// passes whose every intermediate is a full [H, W] tensor in device memory.
// This kernel does the stage of one launch-grid lane in one thread, in
// registers: the centre surface, reservoir and RNG state in; for each of
// up to max_samples neighbours the offset (the low-discrepancy disk, the
// view clamp, the checkerboard shift), the neighbour's surface decoded
// from the G-buffer planes (RtxdiApplicationBridge.glsl:295-321), the
// neighbour and material tests, the neighbour's reservoir gathered and
// its resampling; then the canonical sample (pairwise) or the basic bias
// correction's second pass over the neighbours (modes 0 and 1; it recomputes
// each neighbour's offset and surface instead of keeping them); the output
// reservoir and RNG index out. Mode 3 casts visibility rays between its
// two passes and stays the plain version's.
//
// The same values as the plain version on the card, in its order: every
// float32 operation is its own rounded IEEE operation (--fmad=false, no
// fast math), min/max/clamp propagate NaN as torch's do, a division of a
// tensor by a Python number is a multiply by its float32 reciprocal
// (torch's CUDA kernel for a CPU scalar divisor), a three- and four-term
// sum over a trailing dimension adds in the order torch's CUDA reduction
// kernel does (add3, add4), and the transcendentals (powf, exp2f, sinf,
// cosf, atan2f, asinf) are CUDA's, as torch's are. Those orders and bits
// were read off torch 2.11 on an H100; another torch may differ in a last
// bit. The RNG (utils/rng.py's murmur3) runs in native uint32 and draws
// where the plain version's lanes draw: r0 and the canonical draw on
// every lane, a neighbour's draw only on the lanes that merge it. Every
// light type of lights/polymorphic.py::calc_sample (point, triangle,
// directional, environment with the skybox's bilinear lookup) and the
// spot shaping run for the lane's own light record only, which is what the
// plain version selects per lane.
//
// What bounds it: bytes. Counted per lane, each neighbour's reads anew, a
// lane reads its centre surface (21 f32), reservoir (56 B) and RNG state
// (16 B), for each neighbour its G-buffer words as uint32 (28 B) and its
// reservoir (56 B), and writes a reservoir (56 B) and its RNG index (8 B):
// 472 B a lane at three neighbours, 3.9 GB at 3840x2160, ~1.17 ms at
// 3.35 TB/s. (The kernel itself reads less of a reservoir, 48 B of a
// neighbour's and 52 B of the centre's, and more of the G-buffer, whose
// uint32 words are int64 tensors: 36 B.) The arithmetic, some 3,000 FP32
// operations a lane (four target pdfs a merged neighbour), is below it.
// The neighbour gathers land within the sampling radius of the lane, so
// the rows a wave of blocks reads stay in L2.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSamples = 32;

constexpr float kPi = 3.1415926535f;  // RTXDI_PI (brdf.PI)
constexpr float kInvPi = 1.0f / kPi;
constexpr float kTwoPi = 6.283185307f;  // float(2.0 * PI)
constexpr float kInvTwoPi = 1.0f / kTwoPi;
constexpr float kTwoPiPi = 19.739208802f;  // float(2.0 * PI * PI)
constexpr float kQuarterOverPi = 0.07957747155f;  // float(0.25 / PI)
constexpr float kBackgroundDepth = 100000.0f;
constexpr float kMinRoughness = 0.05f;
constexpr float kDistantLight = 1000.0f;
constexpr float kFltMinNormal = 1.17549435e-38f;

constexpr uint32_t kLightIndexMask = 0x7FFFFFFFu;
constexpr uint32_t kShapingEnableBit = 1u << 28;
constexpr int kTriangle = 4, kDirectional = 5, kEnvironment = 6, kPoint = 7;

// The pointer table's slots (ops/di_spatial.py::SLOTS, in this order).
enum Slot {
  // lane inputs, each [n] or [n, c] with a lane stride
  S_PX, S_PY,                                          // i32
  S_WP, S_VD, S_DEPTH, S_N, S_GN, S_ALB, S_F0, S_ROUGH,  // centre surface f32
  // the centre reservoir (its canonical weight is never read)
  S_C_LD, S_C_UV, S_C_WS, S_C_TP, S_C_M, S_C_PV, S_C_SD, S_C_AGE,
  S_SEED, S_INDEX,                                     // RNG, i64
  // the neighbours' reservoir planes [r_rows, r_cols] (sd: [.., 2]); a
  // neighbour's target pdf and canonical weight are never read
  S_R_LD, S_R_UV, S_R_WS, S_R_M, S_R_PV, S_R_SD, S_R_AGE,
  // the G-buffer planes [g_rows, g_cols]
  S_G_DEPTH, S_G_N, S_G_GN, S_G_ALB, S_G_SR,
  // the light table [L] (center [L, 3])
  S_L_CENTER, S_L_CTF, S_L_D1, S_L_D2, S_L_SC, S_L_LR, S_L_AXIS, S_L_CONE,
  S_SKY,   // [sky_h, sky_w, 3] f32, or null: no environment map bound
  S_OFFS,  // [n_offsets, 2] f32
  // outputs, [n] (sd: [n, 2])
  S_O_LD, S_O_UV, S_O_WS, S_O_TP, S_O_M, S_O_PV, S_O_SD, S_O_AGE, S_O_CW,
  S_O_INDEX,
  S_COUNT
};

// The integer and float parameters' slots (ops/di_spatial.py).
enum IntSlot {
  I_N, I_WIDTH, I_HEIGHT, I_G_ROWS, I_G_COLS, I_G_ROW_BASE, I_R_ROWS,
  I_R_COLS, I_R_ROW_BASE, I_N_LIGHTS, I_SKY_H, I_SKY_W, I_NUM_SAMPLES,
  I_BOOST_SAMPLES, I_BIAS_MODE, I_FIELD, I_OFFSET_MASK, I_MATERIAL_TEST,
  I_DISCOUNT_NAIVE, I_COUNT
};
enum FloatSlot {
  F_TARGET_HISTORY, F_RADIUS, F_DEPTH_THRESHOLD, F_NORMAL_THRESHOLD,
  F_VIEWPORT,                 // 2: viewport_size
  F_CLIP_TO_VIEW = F_VIEWPORT + 2,  // 16: mat_clip_to_view, row-major
  F_VIEW_TO_WORLD = F_CLIP_TO_VIEW + 16,  // 9: mat_view_to_world[:3, :3]
  F_CAMERA = F_VIEW_TO_WORLD + 9,  // 3: camera_direction_or_position[:3]
  F_COUNT = F_CAMERA + 3
};

struct Params {
  const void* p[S_COUNT];
  long long s[S_COUNT];  // lane stride in elements (lane inputs)
  int i[I_COUNT];
  float f[F_COUNT];
};

template <typename T>
__device__ __forceinline__ T lane(const Params& P, int slot, long long k,
                                  int c = 0) {
  return static_cast<const T*>(P.p[slot])[k * P.s[slot] + c];
}

template <typename T>
__device__ __forceinline__ T at(const Params& P, int slot, long long k) {
  return static_cast<const T*>(P.p[slot])[k];
}

// ---------------------------------------------------------------------------
// torch's float32 semantics
// ---------------------------------------------------------------------------

// (a + b + c) over a trailing dimension of 3, as torch's CUDA reduction
// adds it: two threads, the first holding a and c
__device__ __forceinline__ float add3(float a, float b, float c) {
  return (a + c) + b;
}
// (a + b + c + d) over a trailing dimension of 4: two threads, holding a
// and c, b and d
__device__ __forceinline__ float add4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return add3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}
// torch.clamp / clamp_min / clamp_max: a NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float cmin(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float cmax(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
// torch.maximum / minimum: NaN if either is
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// brdf.normalize: v / clamp_min(sqrt(dot(v, v)), 1e-20)
__device__ __forceinline__ void normalize3(const float* v, float* out) {
  const float len = cmin(sqrtf(dot3(v, v)), 1e-20f);
  out[0] = v[0] / len;
  out[1] = v[1] / len;
  out[2] = v[2] / len;
}
__device__ __forceinline__ float lum601(const float* c) {
  return add3(c[0] * 0.299f, c[1] * 0.587f, c[2] * 0.114f);
}
// RtxdiMath compareRelativeDifference
__device__ __forceinline__ bool rel_close(float ref, float cand, float thr) {
  return thr <= 0.0f || fabsf(ref - cand) <= thr * tmax(ref, cand);
}
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kFltMinNormal ? 0.0f : x;
}
__device__ __forceinline__ float f16(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(
      bits & 0xFFFFu)));
}

// ---------------------------------------------------------------------------
// RNG (utils/rng.py: murmur3, sample_uniform)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int y) {
  return (x << y) | (x >> (32 - y));
}
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t index) {
  uint32_t k = index * 0xCC9E2D51u;
  k = rotl(k, 15);
  k *= 0x1B873593u;
  uint32_t h = seed ^ k;
  h = rotl(h, 13) * 5u + 0xE6546B64u;
  h ^= 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __uint_as_float((h & 0x7FFFFFu) | 0x3F800000u) - 1.0f;
}

// ---------------------------------------------------------------------------
// Packed formats (utils/packing.py)
// ---------------------------------------------------------------------------

// oct_unorm32_to_ndir
__device__ void oct_decode(uint32_t v, float* n) {
  constexpr float kInv = 1.0f / 65534.0f;
  float px = clampf(static_cast<float>(v & 0xFFFFu) * kInv, 0.0f, 1.0f);
  float py = clampf(static_cast<float>(v >> 16) * kInv, 0.0f, 1.0f);
  px = px * 2.0f - 1.0f;
  py = py * 2.0f - 1.0f;
  const float nz = (1.0f - fabsf(px)) - fabsf(py);
  const float t = cmin(-nz, 0.0f);
  float m[3] = {px + (px >= 0.0f ? -t : t), py + (py >= 0.0f ? -t : t), nz};
  const float len = sqrtf(dot3(m, m));
  n[0] = m[0] / len;
  n[1] = m[1] / len;
  n[2] = m[2] / len;
}

__device__ __forceinline__ float unorm8(uint32_t v, int shift) {
  return static_cast<float>((v >> shift) & 0xFFu) * (1.0f / 255.0f);
}

// ---------------------------------------------------------------------------
// Surfaces
// ---------------------------------------------------------------------------

struct Surf {
  float wp[3], vd[3], depth, n[3], gn[3], alb[3], f0[3], rough;
};

// surface_from_gbuffer at (px, py) of the current frame's planes
__device__ void gbuffer_surface(const Params& P, int px, int py, Surf& s) {
  const int width = P.i[I_WIDTH], height = P.i[I_HEIGHT];
  const bool in_view = px >= 0 && px < width && py >= 0 && py < height;
  const int x = clampi(px, 0, width - 1);
  const int y = clampi(clampi(py, 0, height - 1) - P.i[I_G_ROW_BASE], 0,
                       P.i[I_G_ROWS] - 1);
  const long long k = static_cast<long long>(y) * P.i[I_G_COLS] + x;
  s.depth = in_view ? at<float>(P, S_G_DEPTH, k) : kBackgroundDepth;
  oct_decode(static_cast<uint32_t>(at<long long>(P, S_G_N, k)), s.n);
  oct_decode(static_cast<uint32_t>(at<long long>(P, S_G_GN, k)), s.gn);
  const uint32_t alb = static_cast<uint32_t>(at<long long>(P, S_G_ALB, k));
  s.alb[0] = static_cast<float>(alb & 2047u) * (1.0f / 2047.0f);
  s.alb[1] = static_cast<float>((alb >> 11) & 2047u) * (1.0f / 2047.0f);
  s.alb[2] = static_cast<float>((alb >> 22) & 1023u) * (1.0f / 1023.0f);
  const uint32_t sr = static_cast<uint32_t>(at<long long>(P, S_G_SR, k));
  for (int c = 0; c < 3; ++c)
    s.f0[c] = powf(clampf(unorm8(sr, 8 * c), 0.0f, 1.0f), 2.2f);
  s.rough = powf(clampf(unorm8(sr, 24), 0.0f, 1.0f), 2.2f);

  // view_depth_to_world_pos (setup_primary_ray) at the global pixel
  const float* F = P.f;
  const float dx = ((static_cast<float>(x) + 0.5f) / F[F_VIEWPORT]) * 2.0f
                   - 1.0f;
  const float dy = ((static_cast<float>(y + P.i[I_G_ROW_BASE]) + 0.5f)
                    / F[F_VIEWPORT + 1]) * 2.0f - 1.0f;
  float target[3];
  for (int r = 0; r < 3; ++r) {
    const float* m = F + F_CLIP_TO_VIEW + 4 * r;
    target[r] = add4(m[0] * dx, m[1] * dy, m[2] * 1.0f, m[3] * 1.0f);
  }
  float tdir[3];
  normalize3(target, tdir);
  float to_cam[3];
  for (int r = 0; r < 3; ++r) {
    const float* m = F + F_VIEW_TO_WORLD + 3 * r;
    const float wd = add3(m[0] * tdir[0], m[1] * tdir[1], m[2] * tdir[2]);
    s.wp[r] = F[F_CAMERA + r] + wd * s.depth;
    to_cam[r] = F[F_CAMERA + r] - s.wp[r];
  }
  normalize3(to_cam, s.vd);
}

// ---------------------------------------------------------------------------
// Lights (lights/polymorphic.py, lights/shaping.py)
// ---------------------------------------------------------------------------

struct Sample {
  float pos[3], rad[3], pdf;
};

__device__ __forceinline__ void light_color(uint32_t ctf, uint32_t lr,
                                            float* out) {
  const uint32_t l16 = lr & 0xFFFFu;
  const float val = exp2f(((static_cast<float>(l16) - 1.0f)
                           * (1.0f / 65534.0f)) * 48.0f + -8.0f);
  const float radiance = l16 == 0 ? 0.0f : val;
  for (int c = 0; c < 3; ++c) out[c] = unorm8(ctf, 8 * c) * radiance;
}

__device__ __forceinline__ void sample_disk(float r0, float r1, float* out) {
  const float angle = kTwoPi * r0;
  const float r = sqrtf(r1);
  out[0] = cosf(angle) * r;
  out[1] = sinf(angle) * r;
}

// skybox bilinear lookup (scene/scene.py::sample_equirect)
__device__ void sample_equirect(const Params& P, float u, float v,
                                float* out) {
  const int h = P.i[I_SKY_H], w = P.i[I_SKY_W];
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long x0l = static_cast<long long>(x0);
  const long long y0l = static_cast<long long>(y0);
  long long x0i = x0l % w, x1i = (x0l + 1) % w;
  if (x0i < 0) x0i += w;
  if (x1i < 0) x1i += w;
  const long long y0i = y0l < 0 ? 0 : (y0l > h - 1 ? h - 1 : y0l);
  const long long y1i = y0l + 1 < 0 ? 0 : (y0l + 1 > h - 1 ? h - 1 : y0l + 1);
  const float* sky = static_cast<const float*>(P.p[S_SKY]);
  const float* c00 = sky + 3 * (y0i * w + x0i);
  const float* c10 = sky + 3 * (y0i * w + x1i);
  const float* c01 = sky + 3 * (y1i * w + x0i);
  const float* c11 = sky + 3 * (y1i * w + x1i);
  for (int c = 0; c < 3; ++c)
    out[c] = (c00[c] * (1.0f - fx) + c10[c] * fx) * (1.0f - fy)
             + (c01[c] * (1.0f - fx) + c11[c] * fx) * fy;
}

// calc_sample of light record `li` at uv (u0, u1) for a viewer at `vp`:
// the lane's own type, then the spot shaping where its pdf is positive
__device__ Sample calc_sample(const Params& P, long long li, float u0,
                              float u1, const float* vp) {
  Sample out = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f};
  const uint32_t ctf = static_cast<uint32_t>(at<long long>(P, S_L_CTF, li));
  const int type = static_cast<int>((ctf >> 24) & 0xFu);
  const float* center = static_cast<const float*>(P.p[S_L_CENTER]) + 3 * li;
  const uint32_t d1 = static_cast<uint32_t>(at<long long>(P, S_L_D1, li));
  const uint32_t d2 = static_cast<uint32_t>(at<long long>(P, S_L_D2, li));
  const uint32_t sc = static_cast<uint32_t>(at<long long>(P, S_L_SC, li));
  const uint32_t lr = static_cast<uint32_t>(at<long long>(P, S_L_LR, li));

  if (type == kPoint) {
    float flux[3], lv[3];
    light_color(ctf, lr, flux);
    for (int c = 0; c < 3; ++c) lv[c] = center[c] - vp[c];
    const float dd = cmin(dot3(lv, lv), 1e-20f);
    for (int c = 0; c < 3; ++c) {
      out.pos[c] = center[c];
      out.rad[c] = flux[c] / dd;
    }
    out.pdf = 1.0f;
  } else if (type == kTriangle) {
    const float len1 = f16(sc), len2 = f16(sc >> 16);
    float e1[3], e2[3], radiance[3];
    oct_decode(d1, e1);
    oct_decode(d2, e2);
    for (int c = 0; c < 3; ++c) {
      e1[c] = e1[c] * len1;
      e2[c] = e2[c] * len2;
    }
    light_color(ctf, lr, radiance);
    const float nrm[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                          e1[2] * e2[0] - e1[0] * e2[2],
                          e1[0] * e2[1] - e1[1] * e2[0]};
    const float nlen = sqrtf(dot3(nrm, nrm));
    const bool ok = nlen > 0.0f;
    const float nl = cmin(nlen, 1e-30f);
    const float normal[3] = {ok ? nrm[0] / nl : 0.0f, ok ? nrm[1] / nl : 0.0f,
                             ok ? nrm[2] / nl : 0.0f};
    const float area = ok ? 0.5f * nlen : 0.0f;
    const float sqrtx = sqrtf(u0);
    const float b1 = sqrtx * (1.0f - u1), b2 = sqrtx * u1;
    float l[3];
    for (int c = 0; c < 3; ++c) {
      const float base = center[c] - (e1[c] + e2[c]) * (1.0f / 3.0f);
      out.pos[c] = (base + e1[c] * b1) + e2[c] * b2;
      l[c] = out.pos[c] - vp[c];
      out.rad[c] = radiance[c];
    }
    const float dist = sqrtf(dot3(l, l));
    const float dl = cmin(dist, 1e-20f);
    for (int c = 0; c < 3; ++c) l[c] = l[c] / dl;
    const float area_pdf = 1.0f / cmin(area, 1e-20f);
    const float cos_theta = clampf(-dot3(l, normal), 0.0f, 1.0f);
    out.pdf = (area_pdf * (dist * dist)) / cmin(cos_theta, 1e-20f);
  } else if (type == kDirectional) {
    float dir[3], radiance[3], disk[2];
    oct_decode(d1, dir);
    const float half_angle = f16(sc), solid_angle = f16(sc >> 16);
    const float sin_half = sinf(half_angle);
    light_color(ctf, lr, radiance);
    sample_disk(u0, u1, disk);
    // construct_onb(dir)
    const float sign = dir[2] >= 0.0f ? 1.0f : -1.0f;
    const float a = (1.0f / (sign + dir[2])) * -1.0f;
    const float b = (dir[0] * dir[1]) * a;
    const float tangent[3] = {1.0f + ((sign * dir[0]) * dir[0]) * a,
                              sign * b, -sign * dir[0]};
    const float bitangent[3] = {b, sign + (dir[1] * dir[1]) * a, -dir[1]};
    const float s0 = disk[0] * sin_half, s1 = disk[1] * sin_half;
    for (int c = 0; c < 3; ++c) {
      const float sd = (dir[c] + tangent[c] * s0) + bitangent[c] * s1;
      out.pos[c] = vp[c] - sd * kDistantLight;
      out.rad[c] = radiance[c];
    }
    out.pdf = 1.0f / cmin(solid_angle, 1e-20f);
  } else if (type == kEnvironment) {
    const float rotation = f16(sc);
    const bool importance = (sc >> 16) != 0;
    float scale[3], dir[3], tex_u, tex_v;
    light_color(ctf, lr, scale);
    if (importance) {
      const float tw = static_cast<float>(d2 & 0xFFFFu);
      const float th = static_cast<float>(d2 >> 16);
      const float azimuth = ((u0 + rotation) + 0.25f) * kTwoPi;
      const float elevation = (0.5f - u1) * kPi;
      const float cos_el = cosf(elevation);
      dir[0] = cosf(azimuth) * cos_el;
      dir[1] = sinf(elevation);
      dir[2] = sinf(azimuth) * cos_el;
      out.pdf = (tw * th) / (kTwoPiPi * cmin(cos_el, 1e-6f));
      tex_u = u0;
      tex_v = u1;
    } else {
      const float y = u1 * 2.0f - 1.0f;
      float disk[2];
      sample_disk(u0, 1.0f - y * y, disk);
      dir[0] = disk[0];
      dir[1] = disk[1];
      dir[2] = y;
      out.pdf = kQuarterOverPi;
      tex_u = (0.5f + atan2f(dir[2], dir[0]) * kInvTwoPi) - rotation;
      tex_v = 0.5f - asinf(clampf(dir[1], -1.0f, 1.0f)) * kInvPi;
    }
    float radiance[3] = {0.0f, 0.0f, 0.0f};
    if (P.p[S_SKY] != nullptr) {
      float texel[3];
      sample_equirect(P, tex_u, tex_v, texel);
      for (int c = 0; c < 3; ++c) radiance[c] = scale[c] * texel[c];
    }
    const bool bad = !isfinite(add3(radiance[0], radiance[1], radiance[2]));
    for (int c = 0; c < 3; ++c) {
      out.pos[c] = vp[c] + dir[c] * kDistantLight;
      out.rad[c] = bad ? 0.0f : radiance[c];
    }
  }

  // evaluate_light_shaping (unshaped and unknown types: a factor of 1)
  if ((ctf & kShapingEnableBit) != 0 && out.pdf > 0.0f) {
    const uint32_t ax = static_cast<uint32_t>(at<long long>(P, S_L_AXIS, li));
    const uint32_t cone = static_cast<uint32_t>(
        at<long long>(P, S_L_CONE, li));
    float axis[3], to_surface[3], d[3];
    oct_decode(ax, axis);
    for (int c = 0; c < 3; ++c) d[c] = vp[c] - out.pos[c];
    normalize3(d, to_surface);
    const float cos_theta = dot3(axis, to_surface);
    const float edge0 = f16(cone);
    const float edge1 = edge0 + f16(cone >> 16);
    const float t = clampf((cos_theta - edge0) / cmin(edge1 - edge0, 1e-6f),
                           0.0f, 1.0f);
    const float falloff = ((t * t) * (3.0f - 2.0f * t)) * 1.0f;
    for (int c = 0; c < 3; ++c) out.rad[c] = out.rad[c] * falloff;
  }
  return out;
}

// RAB_GetLightSampleTargetPdfForSurface (render/app_bridge.py)
__device__ float target_pdf(const Sample& ls, const Surf& s) {
  bool live = ls.pdf > 0.0f;
  float v[3], l[3];
  for (int c = 0; c < 3; ++c) v[c] = ls.pos[c] - s.wp[c];
  normalize3(v, l);
  live = live && dot3(l, s.gn) > 0.0f;
  const float nl[3] = {-l[0], -l[1], -l[2]};
  const float d = cmin(-dot3(s.n, nl), 0.0f) * kInvPi;

  // ggx_times_ndotl(view_dir, l, normal, max(roughness, 0.05), f0)
  const float r = cmin(s.rough, kMinRoughness);
  float hv[3], h[3];
  for (int c = 0; c < 3; ++c) hv[c] = l[c] + s.vd[c];
  normalize3(hv, h);
  const float nol = clampf(dot3(s.n, l), 0.0f, 1.0f);
  const float voh = clampf(dot3(s.vd, h), 0.0f, 1.0f);
  const float nov = clampf(dot3(s.n, s.vd), 0.0f, 1.0f);
  const float noh = clampf(dot3(s.n, h), 0.0f, 1.0f);
  const float alpha = r * r;
  const float a2 = alpha * alpha;
  const float g1 = nov * sqrtf(a2 + ((1.0f - a2) * nol) * nol);
  const float g2 = nol * sqrtf(a2 + ((1.0f - a2) * nov) * nov);
  const float g = (2.0f * nol) / cmin(g1 + g2, 1e-20f);
  const float da = ((noh * noh) * alpha) * alpha;
  const float db = 1.0f - noh * noh;
  const float dd = (alpha * alpha) / (kPi * ((da + db * da) + db));
  const float p5 = powf(cmin(1.0f - voh, 0.0f), 5.0f);
  const float dg = (dd * g) * 0.25f;
  float reflected[3];
  for (int c = 0; c < 3; ++c) {
    float spec = (s.f0[c] + (1.0f - s.f0[c]) * p5) * dg;
    spec = nol > 0.0f ? spec : 0.0f;
    spec = s.rough == 0.0f ? 0.0f : spec;
    reflected[c] = ls.rad[c] * (d * s.alb[c] + spec);
  }
  const float pdf = lum601(reflected) / cmin(ls.pdf, 1e-30f);
  return live ? pdf : 0.0f;
}

// RAB_LoadLightInfo + RAB_SamplePolymorphicLight + the target pdf of a
// reservoir's sample at a surface (_target_pdf_helper)
__device__ __forceinline__ float sample_pdf(const Params& P, long long ld,
                                            long long uv, const Surf& s) {
  long long li = ld & kLightIndexMask;
  const long long last = P.i[I_N_LIGHTS] - 1;
  li = li > last ? last : li;
  const float u0 = static_cast<float>(uv & 0xFFFF) * (1.0f / 65535.0f);
  const float u1 = static_cast<float>(uv >> 16) * (1.0f / 65535.0f);
  return target_pdf(calc_sample(P, li, u0, u1, s.wp), s);
}

// ---------------------------------------------------------------------------
// Reservoirs (restir/di_reservoir.py)
// ---------------------------------------------------------------------------

struct Res {
  long long ld, uv, pv, age;
  float ws, tp, m, cw;
  int sd0, sd1;
};

// a neighbour's reservoir (tp and cw left 0: nothing reads them)
__device__ __forceinline__ Res gather_res(const Params& P, long long k) {
  Res r;
  r.ld = at<long long>(P, S_R_LD, k);
  r.uv = at<long long>(P, S_R_UV, k);
  r.ws = at<float>(P, S_R_WS, k);
  r.tp = 0.0f;
  r.m = at<float>(P, S_R_M, k);
  r.pv = at<long long>(P, S_R_PV, k);
  const int2 sd = static_cast<const int2*>(P.p[S_R_SD])[k];
  r.sd0 = sd.x;
  r.sd1 = sd.y;
  r.age = at<long long>(P, S_R_AGE, k);
  r.cw = 0.0f;
  return r;
}

// internal_simple_resample on an active lane: takes `cand`'s sample with
// target pdf `tp` on a select, which it returns
__device__ __forceinline__ bool resample(Res& st, const Res& cand, float rnd,
                                         float tp, float normalization,
                                         float sample_m) {
  const float ris = tp * normalization;
  st.m = st.m + sample_m;
  st.ws = st.ws + ris;
  const bool select = rnd * st.ws < ris;
  if (select) {
    st.ld = cand.ld;
    st.uv = cand.uv;
    st.tp = tp;
    st.pv = cand.pv;
    st.sd0 = cand.sd0;
    st.sd1 = cand.sd1;
    st.age = cand.age;
  }
  return select;
}

// finalize_resampling's weight
__device__ __forceinline__ float finalized(const Res& st, float numerator,
                                           float denominator) {
  const float den = flush(st.tp * denominator);
  return den == 0.0f ? 0.0f : flush(st.ws * numerator) / den;
}

// RtxdiMath pairwise MIS weight and M factor
__device__ __forceinline__ float pairwise_weight(float w0, float w1, float m0,
                                                 float m1) {
  const float denom = m0 * w0 + m1 * w1;
  return denom <= 0.0f ? 0.0f : cmin(m0 * w0, 0.0f) / denom;
}
__device__ __forceinline__ float m_factor(float q0, float q1) {
  const float r = clampf(powf(cmax(q1 / cmin(q0, 1e-30f), 1.0f), 8.0f),
                         0.0f, 1.0f);
  return q0 <= 0.0f ? 1.0f : r;
}

// ---------------------------------------------------------------------------
// Neighbours
// ---------------------------------------------------------------------------

struct Neighbor {
  int x, y, ox, oy;
};

// calculate_spatial_resampling_offset, clamp_sample_position_into_view,
// activate_checkerboard_pixel(previous_frame=False)
__device__ __forceinline__ Neighbor neighbor_at(const Params& P, int px,
                                                int py, int start, int i) {
  const int idx = (start + i) & P.i[I_OFFSET_MASK];
  const float2 off = static_cast<const float2*>(P.p[S_OFFS])[idx];
  const float radius = P.f[F_RADIUS];
  Neighbor nb;
  nb.ox = static_cast<int>(off.x * radius);
  nb.oy = static_cast<int>(off.y * radius);
  const int width = P.i[I_WIDTH], height = P.i[I_HEIGHT];
  int x = px + nb.ox, y = py + nb.oy;
  x = x < 0 ? -x : x;
  y = y < 0 ? -y : y;
  x = x >= width ? 2 * width - x - 1 : x;
  y = y >= height ? 2 * height - y - 1 : y;
  const int field = P.i[I_FIELD];
  if (field != 0 && ((x + y) & 1) != (field & 1)) x += (y & 1) != 0 ? 1 : -1;
  nb.x = x;
  nb.y = y;
  return nb;
}

// the neighbours' reservoir plane index of pixel (x, y) (_gather_di)
__device__ __forceinline__ long long reservoir_index(const Params& P, int x,
                                                     int y) {
  const int rx = P.i[I_FIELD] != 0 ? (x >> 1) : x;
  const int ry = clampi(y, 0, P.i[I_HEIGHT] - 1) - P.i[I_R_ROW_BASE];
  const int xi = clampi(rx, 0, P.i[I_R_COLS] - 1);
  const int yi = clampi(ry, 0, P.i[I_R_ROWS] - 1);
  return static_cast<long long>(yi) * P.i[I_R_COLS] + xi;
}

__device__ __forceinline__ bool similar(const Params& P, const Surf& c,
                                        float c_lum_f0, float c_lum_alb,
                                        const Surf& n) {
  bool ok = n.depth != kBackgroundDepth
            && dot3(c.n, n.n) >= P.f[F_NORMAL_THRESHOLD]
            && rel_close(c.depth, n.depth, P.f[F_DEPTH_THRESHOLD]);
  if (P.i[I_MATERIAL_TEST])  // RAB_AreMaterialsSimilar
    ok = ok && rel_close(c.rough, n.rough, 0.5f)
         && fabsf(c_lum_f0 - lum601(n.f0)) <= 0.25f
         && fabsf(c_lum_alb - lum601(n.alb)) <= 0.25f;
  return ok;
}

__global__ void __launch_bounds__(kThreads)
    di_spatial_kernel(const Params P) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (k >= P.i[I_N]) return;

  const int px = lane<int>(P, S_PX, k), py = lane<int>(P, S_PY, k);
  Surf cs;
  for (int c = 0; c < 3; ++c) {
    cs.wp[c] = lane<float>(P, S_WP, k, c);
    cs.vd[c] = lane<float>(P, S_VD, k, c);
    cs.n[c] = lane<float>(P, S_N, k, c);
    cs.gn[c] = lane<float>(P, S_GN, k, c);
    cs.alb[c] = lane<float>(P, S_ALB, k, c);
    cs.f0[c] = lane<float>(P, S_F0, k, c);
  }
  cs.depth = lane<float>(P, S_DEPTH, k);
  cs.rough = lane<float>(P, S_ROUGH, k);
  Res cr;
  cr.ld = lane<long long>(P, S_C_LD, k);
  cr.uv = lane<long long>(P, S_C_UV, k);
  cr.ws = lane<float>(P, S_C_WS, k);
  cr.tp = lane<float>(P, S_C_TP, k);
  cr.m = lane<float>(P, S_C_M, k);
  cr.pv = lane<long long>(P, S_C_PV, k);
  cr.sd0 = lane<int>(P, S_C_SD, k, 0);
  cr.sd1 = lane<int>(P, S_C_SD, k, 1);
  cr.age = lane<long long>(P, S_C_AGE, k);
  cr.cw = 0.0f;
  const uint32_t seed = static_cast<uint32_t>(lane<long long>(P, S_SEED, k));
  uint32_t index = static_cast<uint32_t>(lane<long long>(P, S_INDEX, k));

  const int num = P.i[I_NUM_SAMPLES], boost = P.i[I_BOOST_SAMPLES];
  const int max_samples = min(max(num, boost), kMaxSamples);
  const int lane_samples = cr.m < P.f[F_TARGET_HISTORY] ? max(boost, num)
                                                         : num;
  const float num_neighbors = static_cast<float>(lane_samples);
  const bool pairwise = P.i[I_BIAS_MODE] == 2;
  const float c_lum_f0 = lum601(cs.f0), c_lum_alb = lum601(cs.alb);

  Res st = {0, 0, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0};
  if (!pairwise) resample(st, cr, 0.5f, cr.tp, cr.ws * cr.m, cr.m);

  const float r0 = uniform(seed, index++);
  const int start = static_cast<int>(r0 * static_cast<float>(
      P.i[I_OFFSET_MASK]));

  int valid_spatial = 0, selected = -1;
  uint32_t ok_bits = 0;
  bool have_c_at_c = false;
  float c_at_c = 0.0f;
  for (int i = 0; i < max_samples; ++i) {
    const Neighbor nb = neighbor_at(P, px, py, start, i);
    Surf ns;
    gbuffer_surface(P, nb.x, nb.y, ns);
    bool ok = i < lane_samples && similar(P, cs, c_lum_f0, c_lum_alb, ns);
    Res nr = gather_res(P, reservoir_index(P, nb.x, nb.y));
    nr.sd0 += nb.ox;
    nr.sd1 += nb.oy;
    if (P.i[I_DISCOUNT_NAIVE]) ok = ok && !(nr.ld != 0 && nr.m <= 2.0f);
    if (ok) ok_bits |= 1u << i;

    if (pairwise) {
      valid_spatial += ok ? 1 : 0;
      if (!(ok && nr.m > 0.0f)) continue;  // only merging lanes draw
      const float rnd = uniform(seed, index++);
      if (!have_c_at_c) {
        c_at_c = cmin(sample_pdf(P, cr.ld, cr.uv, cs), 0.0f);
        have_c_at_c = true;
      }
      const float n_at_c = cmin(sample_pdf(P, nr.ld, nr.uv, cs), 0.0f);
      const float c_at_n = cmin(sample_pdf(P, cr.ld, cr.uv, ns), 0.0f);
      const float n_at_n = cmin(sample_pdf(P, nr.ld, nr.uv, ns), 0.0f);
      const float nm = nr.m * num_neighbors;
      const float w0 = pairwise_weight(n_at_n, n_at_c, nm, cr.m);
      const float w1 = pairwise_weight(c_at_n, c_at_c, nm, cr.m);
      const float m = nr.m * tmin(m_factor(n_at_n, n_at_c),
                                  m_factor(c_at_n, c_at_c));
      st.cw = st.cw + (1.0f - w1);
      resample(st, nr, rnd, n_at_c, nr.ws * w0, m);
    } else {
      if (!ok) continue;
      const float weight = nr.ld != 0 ? sample_pdf(P, nr.ld, nr.uv, cs)
                                      : 0.0f;
      const float rnd = uniform(seed, index++);
      if (resample(st, nr, rnd, weight, nr.ws * nr.m, nr.m)) selected = i;
    }
  }

  if (pairwise) {
    if (valid_spatial <= 0) st.cw = 1.0f;
    const float rnd = uniform(seed, index++);
    resample(st, cr, rnd, cr.tp, cr.ws * st.cw, cr.m);
    st.ws = finalized(st, 1.0f,
                      cmin(static_cast<float>(valid_spatial), 1.0f));
  } else if (st.ld != 0) {
    // (:610) the normalization applies to valid reservoirs only
    if (P.i[I_BIAS_MODE] >= 1) {
      float pi = st.tp, pi_sum = st.tp * cr.m;
      for (int i = 0; i < max_samples; ++i) {
        if (!((ok_bits >> i) & 1u)) continue;
        const Neighbor nb = neighbor_at(P, px, py, start, i);
        Surf ns;
        gbuffer_surface(P, nb.x, nb.y, ns);
        const float ps = sample_pdf(P, st.ld, st.uv, ns);
        const float n_m = at<float>(P, S_R_M, reservoir_index(P, nb.x, nb.y));
        if (selected == i) pi = ps;
        pi_sum = pi_sum + ps * n_m;
      }
      st.ws = finalized(st, pi, pi_sum);
    } else {
      st.ws = finalized(st, 1.0f, st.m);
    }
  }

  long long* o_ld = static_cast<long long*>(const_cast<void*>(P.p[S_O_LD]));
  o_ld[k] = st.ld;
  static_cast<long long*>(const_cast<void*>(P.p[S_O_UV]))[k] = st.uv;
  static_cast<float*>(const_cast<void*>(P.p[S_O_WS]))[k] = st.ws;
  static_cast<float*>(const_cast<void*>(P.p[S_O_TP]))[k] = st.tp;
  static_cast<float*>(const_cast<void*>(P.p[S_O_M]))[k] = st.m;
  static_cast<long long*>(const_cast<void*>(P.p[S_O_PV]))[k] = st.pv;
  static_cast<int2*>(const_cast<void*>(P.p[S_O_SD]))[k] =
      make_int2(st.sd0, st.sd1);
  static_cast<long long*>(const_cast<void*>(P.p[S_O_AGE]))[k] = st.age;
  static_cast<float*>(const_cast<void*>(P.p[S_O_CW]))[k] = st.cw;
  static_cast<long long*>(const_cast<void*>(P.p[S_O_INDEX]))[k] =
      static_cast<long long>(index);
}

}  // namespace

extern "C" {

// ptrs[S_COUNT]: device pointers in Slot order (S_SKY may be null);
// strides[S_COUNT]: each lane input's lane stride in elements; ints[I_COUNT]
// and floats[F_COUNT] in IntSlot and FloatSlot order (ops/di_spatial.py
// writes all four). Launches on `stream`; returns cudaGetLastError() (0 on
// success).
int rt2_di_spatial(void* const* ptrs, const long long* strides,
                   const int* ints, const float* floats, void* stream) {
  Params P;
  for (int s = 0; s < S_COUNT; ++s) {
    P.p[s] = ptrs[s];
    P.s[s] = strides[s];
  }
  for (int s = 0; s < I_COUNT; ++s) P.i[s] = ints[s];
  for (int s = 0; s < F_COUNT; ++s) P.f[s] = floats[s];
  const int n = P.i[I_N];
  if (n <= 0) return 0;
  if (P.i[I_N_LIGHTS] <= 0 || P.i[I_NUM_SAMPLES] < 0
      || P.i[I_BOOST_SAMPLES] < 0 || P.i[I_BIAS_MODE] < 0
      || P.i[I_BIAS_MODE] > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  di_spatial_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: resident blocks per SM, threads per block, registers per
// thread, shared bytes per block. Returns a cudaError_t (0 on success).
int rt2_di_spatial_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, di_spatial_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, di_spatial_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

}  // extern "C"
