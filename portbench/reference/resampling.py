"""The four reuse stages of ReSTIR, for a list of pixels: GI temporal and
spatial resampling (RTXDI's GIResamplingFunctions.hlsli:186-359 and
:391-553, run as temporal_resampling.rgen:13-48 and
spatial_resampling.rgen:13-39 launch them) and DI temporal and spatial
resampling (DIResamplingFunctions.hlsli:170-360 and :409-494, the
pairwise-MIS spatial variant), each given what the stage reads: the
G-buffer planes of this frame and the last, the camera of each, the
screen-space motion, the reservoirs the stage starts from and the whole
reservoir image its neighbours come from.

Surfaces are rebuilt from the packed planes (RtxdiApplicationBridge.glsl:
295-321): the camera ray times the depth, the octahedral normals, the
unorm albedo and the gamma RGBA8 F0 and roughness. Random numbers are the
renderer's murmur3 sampler (rng.py): the GI stages seed it per pixel
(frame + 7 x 13 and frame + 8 x 13); the DI stages continue the stream
the fused pass hands them, so they take its (seed, index) at each pixel.
A lane draws only where the shader's lane would.

Departures, each from the shader source as the program's configuration
runs it:
- bias correction 2 (pairwise) in the DI temporal stage runs as basic MIS
  (DIResamplingFunctions.hlsli:181-185), so no visibility ray is cast and
  the visibility shortcut, a mode-3 test, never applies; mode 3 is not
  implemented;
- the DI stage reads the motion plane as it is stored, in pixels; the GI
  stage scales it by the two viewports' ratio
  (convertMotionVectorToPixelSpace), which is 1 here;
- the disocclusion boost takes max(boost, samples) samples where a centre
  reservoir's M is below the history length: with 2 boost samples and 3
  samples every pixel takes 3;
- light records keep a triangle as its centroid, two octahedral unit
  edges (2x16 unorm) and their float16 lengths (PolymorphicLight.glsl:
  345-357), and its radiance as lighting.stored_radiance does: the light
  sample's point is taken on that stored triangle;
- an index past the scene's triangle lights (the empty and environment
  records) gives a target pdf of 0: the scenes have no environment map;
- no checkerboard field, no permutation sampling, no boiling filter (the
  configuration's settings); the neighbour offsets are the low-discrepancy
  disk of light_passes.rs:671-698, stored as bytes over 127.

dtype computes every float in that type (the control of the checks runs
bfloat16). Each stage returns its output reservoirs at the pixels, [n]
fields of a GIRes or DIRes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import camera, lighting, rng
from portbench.reference import packing as pk

BACKGROUND_DEPTH = 100000.0
MAX_DI_M = 0x3FFF  # the packed DI reservoir's M field (DIReservoir.hlsli)
LIGHT_INDEX_MASK = 0x7FFFFFFF
M32 = 0xFFFFFFFF
FLT_MIN_NORMAL = float(torch.finfo(torch.float32).tiny)


class Camera(NamedTuple):
    position: tuple
    direction: tuple
    width: int
    height: int


class Planes(NamedTuple):
    """A G-buffer's packed [H, W] planes."""

    depth: torch.Tensor
    normals: torch.Tensor
    geo_normals: torch.Tensor
    albedo: torch.Tensor
    spec_rough: torch.Tensor


class Surf(NamedTuple):
    pos: torch.Tensor
    view: torch.Tensor
    depth: torch.Tensor
    normal: torch.Tensor
    geo_normal: torch.Tensor
    albedo: torch.Tensor
    f0: torch.Tensor
    roughness: torch.Tensor

    @property
    def valid(self):
        return self.depth != BACKGROUND_DEPTH


class GIRes(NamedTuple):
    position: torch.Tensor
    normal: torch.Tensor
    radiance: torch.Tensor
    weight_sum: torch.Tensor
    m: torch.Tensor  # int64
    age: torch.Tensor  # int64


class DIRes(NamedTuple):
    light_data: torch.Tensor  # int64 (uint32 words)
    uv_data: torch.Tensor
    weight_sum: torch.Tensor
    target_pdf: torch.Tensor
    m: torch.Tensor  # float
    age: torch.Tensor  # int64
    canonical_weight: torch.Tensor


class GIParams(NamedTuple):
    max_history_length: int = 20
    max_reservoir_age: int = 50
    temporal_depth_threshold: float = 0.1
    temporal_normal_threshold: float = 0.3
    enable_fallback_sampling: bool = True
    spatial_depth_threshold: float = 0.1
    spatial_normal_threshold: float = 0.3
    num_spatial_samples: int = 1
    spatial_sampling_radius: float = 3.0
    neighbor_offset_mask: int = 8191


class DIParams(NamedTuple):
    max_history_length: int = 5
    temporal_depth_threshold: float = 0.1
    temporal_normal_threshold: float = 0.3
    num_spatial_samples: int = 3
    num_disocclusion_boost_samples: int = 2
    spatial_sampling_radius: float = 32.0
    spatial_depth_threshold: float = 0.1
    spatial_normal_threshold: float = 0.3
    neighbor_offset_mask: int = 8191


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.clamp_min(torch.sqrt(_dot(v, v)), 1e-20)[..., None]


def _lum601(c):
    w = torch.tensor([0.299, 0.587, 0.114], dtype=c.dtype, device=c.device)
    return (c * w).sum(-1)


def _lum709(c):
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=c.dtype, device=c.device)
    return (c * w).sum(-1)


def _where(mask, a: tuple, b: tuple):
    """Per lane, a where mask else b, for every field of a named tuple."""
    return type(a)(*(torch.where(mask[:, None] if x.dim() > 1 else mask, x, y)
                     for x, y in zip(a, b)))


def _close(a, b, tol):
    """compare_relative_difference (RtxdiMath.hlsli:18-21)."""
    return (tol <= 0) | ((a - b).abs() <= tol * torch.maximum(a, b))


def _neighbor_ok(s: Surf, t: Surf, our_depth, normal_tol, depth_tol):
    """The edge-stopping test (RtxdiMath.hlsli:25-29)."""
    return (_dot(s.normal, t.normal) >= normal_tol) & _close(
        our_depth, t.depth, depth_tol)


def _similar(a: Surf, b: Surf):
    """RAB_AreMaterialsSimilar (bridge:600-616)."""
    return (_close(a.roughness, b.roughness, 0.5)
            & ((_lum601(a.f0) - _lum601(b.f0)).abs() <= 0.25)
            & ((_lum601(a.albedo) - _lum601(b.albedo)).abs() <= 0.25))


def _clamp_into_view(x, y, w: int, h: int):
    """RAB_ClampSamplePositionIntoView (bridge:252-265): mirror at the
    edges."""
    x = torch.where(x < 0, -x, x)
    y = torch.where(y < 0, -y, y)
    x = torch.where(x >= w, 2 * w - x - 1, x)
    y = torch.where(y >= h, 2 * h - y - 1, y)
    return x, y


def neighbor_offsets(count: int = 8192, device="cpu") -> torch.Tensor:
    """[count, 2] the spatial neighbours' disk offsets in [-1, 1]: points
    of the plastic sequence inside the disk, stored as the byte
    int((u - 0.5) x 250) read as a signed normalised value (over 127)."""
    phi = 1.0 / 1.3247179572447
    u = v = 0.5
    out = []
    while len(out) < count:
        u += phi
        v += phi * phi
        u -= 1.0 if u >= 1.0 else 0.0
        v -= 1.0 if v >= 1.0 else 0.0
        if (u - 0.5) ** 2 + (v - 0.5) ** 2 <= 0.25:
            out.append((int((u - 0.5) * 250.0), int((v - 0.5) * 250.0)))
    return torch.tensor(out, dtype=torch.float32, device=device) / 127.0


def _spatial_offset(table, index, radius: float, mask: int):
    off = table[(index & mask).long()] * radius
    return off[:, 0].to(torch.int64), off[:, 1].to(torch.int64)


def _temporal_offset(index, radius: int):
    """The 8-point ring (GIResamplingFunctions.hlsli:113-130)."""
    s = index & 7
    m2 = (s >> 1) & 1
    m4 = 1 - ((s >> 2) & 1)
    t0 = -1 + 2 * (s & 1)
    return (t0 * (m4 | m2) * radius,
            t0 * (1 - 2 * m2) * (m4 | (1 - m2)) * radius)


class Stream:
    """The renderer's per-pixel sampler from (seed, index): draw() gives
    the next uniform; only the lanes of `where` move on."""

    def __init__(self, seed, index, dtype):
        self.seed, self.index, self.dtype = seed.long(), index.long(), dtype

    def draw(self, where=None):
        value = rng.uniform(self.seed, self.index).to(self.dtype)
        step = 1 if where is None else where.long()
        self.index = (self.index + step) & M32
        return value


# ---------------------------------------------------------------------------
# Surfaces and target pdfs
# ---------------------------------------------------------------------------

def surface_at(planes: Planes, cam: Camera, x, y, dtype) -> Surf:
    """The surface a G-buffer holds at pixels (x, y); out of view, an
    invalid one (depth BACKGROUND_DEPTH)."""
    w, h = cam.width, cam.height
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xc, yc = x.clamp(0, w - 1).long(), y.clamp(0, h - 1).long()
    depth = torch.where(inside, planes.depth[yc, xc].float(),
                        BACKGROUND_DEPTH)
    o, d = camera.primary_rays(xc, yc, cam.position, cam.direction, w, h,
                               dtype)
    pos = o + d * depth.to(dtype)[:, None]
    sr = pk.rgba8_gamma(planes.spec_rough[yc, xc]).to(dtype)
    return Surf(pos=pos, view=_unit(o - pos), depth=depth.to(dtype),
                normal=pk.octahedral_normal(planes.normals[yc, xc]).to(dtype),
                geo_normal=pk.octahedral_normal(
                    planes.geo_normals[yc, xc]).to(dtype),
                albedo=pk.r11g11b10(planes.albedo[yc, xc]).to(dtype),
                f0=sr[:, :3], roughness=sr[:, 3])


def _brdf(s: Surf, to_light):
    return lighting.brdf(lighting.Shading(
        pos=s.pos, normal=s.normal, view=s.view, albedo=s.albedo, f0=s.f0,
        roughness=s.roughness), to_light)


def gi_target_pdf(position, radiance, s: Surf):
    """RAB_GetGISampleTargetPdfForSurface (bridge:687-694): the Rec.709
    luminance of the sample's light reflected toward the viewer."""
    lam, spec = _brdf(s, _unit(position - s.pos))
    return _lum709(radiance * (lam[:, None] * s.albedo + spec))


class StoredLights(NamedTuple):
    base: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    area: torch.Tensor
    radiance: torch.Tensor


def _oct_code(n: torch.Tensor) -> torch.Tensor:
    """A unit vector's 2x16 unorm octahedral code (Helpers.glsl:263-268)."""
    p = n[:, :2] / n.abs().sum(-1, keepdim=True)
    wrap = (1.0 - p.flip(-1).abs()) * torch.where(p >= 0, 1.0, -1.0)
    p = torch.where(n[:, 2:3] < 0.0, wrap, p)
    q = torch.clamp(p * 0.5 + 0.5, 0.0, 1.0)
    code = (q * float(0xFFFE)).long()
    return code[:, 0] | (code[:, 1] << 16)


def stored_lights(scene, device) -> StoredLights:
    """The scene's triangle lights as the light records keep them."""
    lt = lighting.triangle_lights(scene)
    center = lt.v0 + (lt.e1 + lt.e2) / 3.0

    def edge(e):
        length = torch.sqrt(_dot(e, e))
        unit = e / torch.clamp_min(length, 1e-20)[:, None]
        return (pk.octahedral_normal(_oct_code(unit))
                * length.half().float()[:, None])

    e1, e2 = edge(lt.e1), edge(lt.e2)
    c = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    length = torch.sqrt(_dot(c, c))
    ok = length > 0.0
    return StoredLights(
        base=(center - (e1 + e2) / 3.0).to(device), e1=e1.to(device),
        e2=e2.to(device),
        normal=torch.where(ok[:, None], c / torch.clamp_min(
            length, 1e-30)[:, None], 0.0).to(device),
        area=torch.where(ok, 0.5 * length, 0.0).to(device),
        radiance=lt.radiance.to(device))


def di_target_pdf(lights: StoredLights, light_data, uv_data, s: Surf):
    """RAB_GetLightSampleTargetPdfForSurface (bridge:478-500) of the light
    sample a reservoir names (its light index and 16-bit uv), at s."""
    dtype = s.pos.dtype
    index = light_data.long() & LIGHT_INDEX_MASK
    local = index < lights.base.shape[0]
    i = torch.where(local, index, 0)
    uv = torch.stack([(uv_data & 0xFFFF).float(), (uv_data >> 16).float()],
                     -1).to(dtype) / 65535.0
    su = torch.sqrt(uv[:, 0])
    b1, b2 = (su * (1.0 - uv[:, 1]))[:, None], (su * uv[:, 1])[:, None]
    lt = StoredLights(*(x.to(dtype) for x in lights))
    y = lt.base[i] + lt.e1[i] * b1 + lt.e2[i] * b2
    l = y - s.pos
    dist = torch.sqrt(_dot(l, l))
    to_light = l / torch.clamp_min(dist, 1e-20)[:, None]
    cos_l = torch.clamp(-_dot(to_light, lt.normal[i]), 0.0, 1.0)
    pdf = (1.0 / torch.clamp_min(lt.area[i], 1e-20)) * (dist * dist) \
        / torch.clamp_min(cos_l, 1e-20)
    live = local & (pdf > 0.0) & (_dot(to_light, s.geo_normal) > 0.0)
    lam, spec = _brdf(s, to_light)
    reflected = lt.radiance[i] * (lam[:, None] * s.albedo + spec)
    return torch.where(live, _lum601(reflected) / torch.clamp_min(pdf, 1e-30),
                       0.0)


# ---------------------------------------------------------------------------
# GI
# ---------------------------------------------------------------------------

def _gi_gather(buf: GIRes, x, y) -> GIRes:
    h, w = buf.weight_sum.shape
    xi, yi = x.clamp(0, w - 1).long(), y.clamp(0, h - 1).long()
    return GIRes(*(f[yi, xi] for f in buf))


def _gi_cast(r: GIRes, dtype) -> GIRes:
    return GIRes(r.position.to(dtype), r.normal.to(dtype),
                 r.radiance.to(dtype), r.weight_sum.to(dtype), r.m.long(),
                 r.age.long())


def _gi_combine(res: GIRes, new: GIRes, random, target, active):
    """RTXDI_CombineGIReservoirs (GIResamplingFunctions.hlsli:28-55)."""
    ris = target * new.weight_sum * new.m.to(target.dtype)
    wsum = res.weight_sum + torch.where(active, ris, 0.0)
    select = active & (random * wsum <= ris)
    out = _where(select, new, res)
    return out._replace(weight_sum=wsum,
                        m=res.m + torch.where(active, new.m, 0)), select


def _gi_finalize(res: GIRes, num, den) -> GIRes:
    zero = den == 0.0
    return res._replace(weight_sum=torch.where(
        zero, 0.0, res.weight_sum * num / torch.where(zero, 1.0, den)))


def _jacobian(recv, neighbor_recv, n: GIRes):
    """The solid-angle reuse Jacobian (GIResamplingFunctions.hlsli:67-93)
    and RAB_ValidateGISampleWithJacobian (bridge:673-684): (usable,
    the Jacobian clamped to [1/3, 3])."""
    def part(r):
        vec = r - n.position
        dist = torch.sqrt(_dot(vec, vec))
        cos = torch.clamp(_dot(n.normal, vec / torch.clamp_min(
            dist, 1e-30)[:, None]), 0.0, 1.0)
        return dist, cos

    nd, nc = part(recv)
    od, oc = part(neighbor_recv)
    den = oc * nd * nd
    jac = (nc * od * od) / torch.clamp_min(den, 1e-30)
    jac = torch.where(den <= 0.0, 0.0, jac)
    jac = torch.where(torch.isfinite(jac), jac, 0.0)
    return (jac <= 10.0) & (jac >= 0.1), torch.clamp(jac, 1.0 / 3.0, 3.0)


def _empty_gi(n, dtype, device) -> GIRes:
    z3 = torch.zeros((n, 3), dtype=dtype, device=device)
    z = torch.zeros(n, dtype=dtype, device=device)
    zi = torch.zeros(n, dtype=torch.int64, device=device)
    return GIRes(z3, z3, z3, z, zi, zi)


def gi_temporal(x, y, planes: Planes, cam: Camera, prev_planes: Planes,
                prev_cam: Camera, motion, frame: int, res_in: GIRes,
                prev_buf: GIRes, p: GIParams, dtype=torch.float32):
    """The GI temporal stage at pixels (x, y): (output reservoir, the
    lanes that took the previous frame's sample). motion [n, 3] the
    G-buffer's; res_in the stage's input reservoirs at the pixels;
    prev_buf the previous frame's GI reservoir image."""
    n, dev = x.shape[0], x.device
    s = surface_at(planes, cam, x, y, dtype)
    res_in = _gi_cast(res_in, dtype)
    stream = Stream(rng.seed(x, y, frame + 7 * 13),
                    torch.ones_like(x.long()), dtype)
    # jittered age limit (temporal_resampling.rgen:39-41)
    max_age = (p.max_reservoir_age * (0.5 + stream.draw() * 0.5)).long()
    # motion to pixel space: the viewports' ratio (GBufferHelpers.glsl:
    # 69-80)
    scale = float(np.float32(prev_cam.width) * np.float32(1.0 / cam.width))
    scale_y = float(np.float32(prev_cam.height)
                    * np.float32(1.0 / cam.height))
    cx = x.float() + 0.5
    cy = y.float() + 0.5
    mx = (cx + motion[:, 0].float()) * scale - cx
    my = (cy + motion[:, 1].float()) * scale_y - cy
    prev_x = torch.round(x.float() + mx).long()
    prev_y = torch.round(y.float() + my).long()
    expected = s.depth + motion[:, 2].to(dtype)
    start = (stream.draw() * 8).to(torch.int64)

    found = torch.zeros(n, dtype=torch.bool, device=dev)
    sel_s, sel = None, _empty_gi(n, dtype, dev)
    count = 5 + int(p.enable_fallback_sampling)
    for i in range(count):
        fallback = i == 5
        if fallback:  # the pixel itself, permuted (uniform number 0)
            ix, iy = x ^ 3, y ^ 3
        elif i == 0:
            ix, iy = prev_x, prev_y
        else:
            ox, oy = _temporal_offset(start + i, 1)
            ix, iy = prev_x + ox, prev_y + oy
        t = surface_at(prev_planes, prev_cam, ix, iy, dtype)
        ok = t.valid
        if not fallback:
            ok = ok & _neighbor_ok(s, t, expected, p.temporal_normal_threshold,
                                   p.temporal_depth_threshold)
        ok = ok & _similar(s, t)
        t_res = _gi_cast(_gi_gather(prev_buf, ix, iy), dtype)
        ok = ok & (t_res.m != 0)
        take = ok & ~found
        sel_s = t if sel_s is None else _where(take, t, sel_s)
        sel = _where(take, t_res, sel)
        found = found | take

    cur = _empty_gi(n, dtype, dev)
    in_valid = res_in.m != 0
    in_pdf = gi_target_pdf(res_in.position, res_in.radiance, s)
    chosen_pdf = torch.where(in_valid, in_pdf, 0.0)
    cur, _ = _gi_combine(cur, res_in, 0.5, in_pdf, in_valid)

    usable, jac = _jacobian(s.pos, sel_s.pos, sel)
    found = found & usable
    sel = sel._replace(weight_sum=sel.weight_sum * jac,
                       m=torch.clamp_max(sel.m, p.max_history_length),
                       age=sel.age + 1)
    found = found & (sel.age <= max_age)

    t_pdf = gi_target_pdf(sel.position, sel.radiance, s)
    cur, took = _gi_combine(cur, sel, stream.draw(found), t_pdf, found)
    chosen_pdf = torch.where(took, t_pdf, chosen_pdf)

    # basic MIS (bias correction 2, GIResamplingFunctions.hlsli:320-348)
    pi = chosen_pdf
    pi_sum = chosen_pdf * res_in.m.to(dtype)
    use = (cur.m != 0) & found
    temporal_p = gi_target_pdf(cur.position, cur.radiance, sel_s)
    pi = torch.where(use & took, temporal_p, pi)
    pi_sum = pi_sum + torch.where(use, temporal_p * sel.m.to(dtype), 0.0)
    cur = _gi_finalize(cur, pi, pi_sum * chosen_pdf)
    valid = s.valid
    return _where(valid, cur, res_in), took & valid


def gi_spatial(x, y, planes: Planes, cam: Camera, frame: int, res_in: GIRes,
               src: GIRes, p: GIParams, offsets, dtype=torch.float32):
    """The GI spatial stage at pixels (x, y): res_in the stage's input at
    the pixels, src the image its neighbours come from (this frame's
    temporal output)."""
    n, dev = x.shape[0], x.device
    s = surface_at(planes, cam, x, y, dtype)
    res_in = _gi_cast(res_in, dtype)
    stream = Stream(rng.seed(x, y, frame + 8 * 13),
                    torch.ones_like(x.long()), dtype)
    cur = _empty_gi(n, dtype, dev)
    in_valid = res_in.m != 0
    in_pdf = gi_target_pdf(res_in.position, res_in.radiance, s)
    chosen_pdf = torch.where(in_valid, in_pdf, 0.0)
    cur, _ = _gi_combine(cur, res_in, 0.5, in_pdf, in_valid)
    start = (stream.draw() * p.neighbor_offset_mask).to(torch.int64)

    chosen = torch.full((n,), -1, dtype=torch.int64, device=dev)
    seen = []
    for i in range(p.num_spatial_samples):
        ox, oy = _spatial_offset(offsets, start + i,
                                 p.spatial_sampling_radius,
                                 p.neighbor_offset_mask)
        ix, iy = _clamp_into_view(x + ox, y + oy, cam.width, cam.height)
        t = surface_at(planes, cam, ix, iy, dtype)
        ok = _neighbor_ok(s, t, s.depth, p.spatial_normal_threshold,
                          p.spatial_depth_threshold) & _similar(s, t)
        t_res = _gi_cast(_gi_gather(src, ix, iy), dtype)
        ok = ok & (t_res.m != 0)
        usable, jac = _jacobian(s.pos, t.pos, t_res)
        t_pdf = gi_target_pdf(t_res.position, t_res.radiance, s)
        ok = ok & usable
        seen.append((t, t_res, ok))
        cur, took = _gi_combine(cur, t_res, stream.draw(ok), t_pdf * jac, ok)
        chosen = torch.where(took, i, chosen)
        chosen_pdf = torch.where(took, t_pdf, chosen_pdf)

    pi = chosen_pdf
    pi_sum = chosen_pdf * res_in.m.to(dtype)
    for i, (t, t_res, ok) in enumerate(seen):
        ps = gi_target_pdf(cur.position, cur.radiance, t)
        pi = torch.where(ok & (chosen == i), ps, pi)
        pi_sum = pi_sum + torch.where(ok, ps * t_res.m.to(dtype), 0.0)
    cur = _gi_finalize(cur, pi, chosen_pdf * pi_sum)
    return _where(s.valid, cur, res_in)


# ---------------------------------------------------------------------------
# DI
# ---------------------------------------------------------------------------

def _di_gather(buf: DIRes, x, y) -> DIRes:
    h, w = buf.weight_sum.shape
    xi, yi = x.clamp(0, w - 1).long(), y.clamp(0, h - 1).long()
    return DIRes(*(f[yi, xi] for f in buf))


def _di_cast(r: DIRes, dtype) -> DIRes:
    return DIRes(r.light_data.long(), r.uv_data.long(),
                 r.weight_sum.to(dtype), r.target_pdf.to(dtype),
                 r.m.to(dtype), r.age.long(), r.canonical_weight.to(dtype))


def _empty_di(n, dtype, device) -> DIRes:
    z = torch.zeros(n, dtype=dtype, device=device)
    zi = torch.zeros(n, dtype=torch.int64, device=device)
    return DIRes(zi, zi, z, z, z, zi, z)


def _resample(res: DIRes, new: DIRes, random, target, norm, m, active=None):
    """RTXDI_InternalSimpleResample (DIReservoir.hlsli:277-310)."""
    ris = target * norm
    if active is None:
        active = torch.ones_like(res.m, dtype=torch.bool)
    wsum = res.weight_sum + torch.where(active, ris, 0.0)
    select = active & (random * wsum < ris)
    keep = res.canonical_weight
    out = _where(select, new._replace(target_pdf=torch.broadcast_to(
        target, res.m.shape).to(res.m.dtype)), res)
    return out._replace(weight_sum=wsum, canonical_weight=keep,
                        m=res.m + torch.where(active, m, 0.0)), select


def _flush(v):
    return torch.where(v.abs() < FLT_MIN_NORMAL, 0.0, v)


def _di_finalize(res: DIRes, num, den) -> DIRes:
    """Equation 6 (DIReservoir.hlsli:332-340); subnormal products flush to
    zero, as the devices the renderer was written for do."""
    d = _flush(res.target_pdf * den)
    zero = d == 0.0
    return res._replace(weight_sum=torch.where(
        zero, 0.0, _flush(res.weight_sum * num) / torch.where(zero, 1.0, d)))


def di_temporal(x, y, planes: Planes, cam: Camera, prev_planes: Planes,
                prev_cam: Camera, motion, seed, index, cur_in: DIRes,
                prev_buf: DIRes, lights: StoredLights, p: DIParams,
                dtype=torch.float32) -> DIRes:
    """The DI temporal stage at pixels (x, y): cur_in the fused pass's
    initial reservoir at the pixels, (seed, index) its sampler there,
    prev_buf the previous frame's shaded DI reservoir image."""
    n, dev = x.shape[0], x.device
    s = surface_at(planes, cam, x, y, dtype)
    cur_in = _di_cast(cur_in, dtype)
    stream = Stream(seed, index, dtype)
    limit = torch.clamp_max(p.max_history_length * cur_in.m, float(MAX_DI_M))
    state, _ = _resample(_empty_di(n, dtype, dev), cur_in, 0.5,
                         cur_in.target_pdf, cur_in.weight_sum * cur_in.m,
                         cur_in.m)
    # a jittered reprojection (DIResamplingFunctions.hlsli:204-207)
    jx, jy = stream.draw(), stream.draw()
    mx = motion[:, 0].to(dtype) + (jx - 0.5)
    my = motion[:, 1].to(dtype) + (jy - 0.5)
    prev_x = torch.round(x.to(dtype) + mx).long()
    prev_y = torch.round(y.to(dtype) + my).long()
    expected = s.depth + motion[:, 2].to(dtype)

    found = torch.zeros(n, dtype=torch.bool, device=dev)
    sel_x, sel_y = prev_x, prev_y
    sel_s = None
    for i in range(9):
        if i == 0:
            ox = oy = torch.zeros_like(prev_x)
        else:
            ox = ((stream.draw(~found) - 0.5) * 4.0).to(torch.int64)
            oy = ((stream.draw(~found) - 0.5) * 4.0).to(torch.int64)
        ix, iy = prev_x + ox, prev_y + oy
        t = surface_at(prev_planes, prev_cam, ix, iy, dtype)
        ok = t.valid & _neighbor_ok(s, t, expected,
                                    p.temporal_normal_threshold,
                                    p.temporal_depth_threshold)
        take = ok & ~found
        sel_x, sel_y = torch.where(take, ix, sel_x), torch.where(take, iy,
                                                                 sel_y)
        sel_s = t if sel_s is None else _where(take, t, sel_s)
        found = found | take

    prev = _di_cast(_di_gather(prev_buf, sel_x.clamp(0, cam.width - 1),
                               sel_y.clamp(0, cam.height - 1)), dtype)
    prev = prev._replace(m=torch.minimum(prev.m, limit),
                         age=(prev.age + 1) & M32)
    at_cur = torch.where(prev.light_data != 0, di_target_pdf(
        lights, prev.light_data, prev.uv_data, s), 0.0)
    rr = stream.draw(found)
    prev_m = torch.where(found, prev.m, 0.0)
    state, took = _resample(state, prev, rr, at_cur, prev.weight_sum * prev.m,
                            prev.m, found)

    # basic MIS (the pairwise mode's temporal stage, :181-185, :320-356)
    pi = state.target_pdf
    pi_sum = state.target_pdf * cur_in.m
    use = (state.light_data != 0) & found & (prev_m > 0)
    temporal_p = di_target_pdf(lights, state.light_data, state.uv_data,
                               sel_s)
    pi = torch.where(use & took, temporal_p, pi)
    pi_sum = pi_sum + torch.where(use, temporal_p * prev_m, 0.0)
    return _di_finalize(state, pi, pi_sum)


def _pairwise_weight(w0, w1, m0, m1):
    """(RtxdiMath.hlsli:112-117)."""
    den = m0 * w0 + m1 * w1
    bad = den <= 0.0
    return torch.where(bad, 0.0, torch.clamp_min(m0 * w0, 0.0)
                       / torch.where(bad, 1.0, den))


def _m_factor(q0, q1):
    """(RtxdiMath.hlsli:104-109)."""
    r = torch.clamp(torch.pow(torch.clamp_max(
        q1 / torch.clamp_min(q0, 1e-30), 1.0), 8.0), 0.0, 1.0)
    return torch.where(q0 <= 0.0, 1.0, r)


def di_spatial(x, y, planes: Planes, cam: Camera, seed, index,
               center: DIRes, src: DIRes, lights: StoredLights, p: DIParams,
               offsets, dtype=torch.float32) -> DIRes:
    """The DI spatial stage with pairwise MIS at pixels (x, y): center
    the stage's input at the pixels, (seed, index) its sampler there, src
    the image the neighbours come from (this frame's temporal output)."""
    n, dev = x.shape[0], x.device
    s = surface_at(planes, cam, x, y, dtype)
    center = _di_cast(center, dtype)
    stream = Stream(seed, index, dtype)
    boost = center.m < p.max_history_length
    samples = max(p.num_disocclusion_boost_samples, p.num_spatial_samples)
    lane_samples = torch.where(boost, samples, p.num_spatial_samples)
    count = min(samples, 32)
    state = _empty_di(n, dtype, dev)
    start = (stream.draw() * p.neighbor_offset_mask).to(torch.int64)
    valid_n = torch.zeros(n, dtype=dtype, device=dev)

    def target(res: DIRes, at: Surf):
        return torch.clamp_min(di_target_pdf(lights, res.light_data,
                                             res.uv_data, at), 0.0)

    for i in range(count):
        ox, oy = _spatial_offset(offsets, start + i,
                                 p.spatial_sampling_radius,
                                 p.neighbor_offset_mask)
        ix, iy = _clamp_into_view(x + ox, y + oy, cam.width, cam.height)
        t = surface_at(planes, cam, ix, iy, dtype)
        ok = ((i < lane_samples) & t.valid
              & _neighbor_ok(s, t, s.depth, p.spatial_normal_threshold,
                             p.spatial_depth_threshold) & _similar(s, t))
        nb = _di_cast(_di_gather(src, ix, iy), dtype)
        valid_n = valid_n + ok.to(dtype)
        merge = ok & (nb.m > 0)
        rr = stream.draw(merge)
        # stream the neighbour with pairwise MIS (:46-83)
        n_at_c, c_at_n = target(nb, s), target(center, t)
        n_at_n, c_at_c = target(nb, t), target(center, s)
        mult = nb.m * lane_samples.to(dtype)
        w0 = _pairwise_weight(n_at_n, n_at_c, mult, center.m)
        w1 = _pairwise_weight(c_at_n, c_at_c, mult, center.m)
        m = nb.m * torch.minimum(_m_factor(n_at_n, n_at_c),
                                 _m_factor(c_at_n, c_at_c))
        state = state._replace(canonical_weight=state.canonical_weight
                               + torch.where(merge, 1.0 - w1, 0.0))
        state, _ = _resample(state, nb, rr, n_at_c, nb.weight_sum * w0, m,
                             merge)

    # the canonical sample last (:479-485)
    state = state._replace(canonical_weight=torch.where(
        valid_n <= 0, 1.0, state.canonical_weight))
    state, _ = _resample(state, center, stream.draw(), center.target_pdf,
                         center.weight_sum * state.canonical_weight, center.m)
    return _di_finalize(state, 1.0, torch.clamp_min(valid_n, 1.0))
