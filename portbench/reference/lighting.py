"""Direct light from the scene's emissive triangles, as the renderer's
ReSTIR DI defines it: one-sided triangle lights (PolymorphicLight.glsl:
266-357) whose record keeps the radiance as a 16-bit log2 intensity and an
RGB8 colour (:65-93), shaded through ShadeSurfaceWithLightSample
(ShadingHelpers.glsl:2-58) with the bridge's split BRDF (Lambert over pi,
and the GGX specular times N.L of Helpers.glsl:189-233, with its
unparenthesised `square` macro), the specular demodulated by F0 floored
at 0.01 (Helpers.glsl:312-315).

shade_sample() is the contribution of one chosen light sample; many_light()
the plain estimate of the whole integral over every emissive triangle, by
a fixed quadrature of sub-triangle centroids with brute-force visibility.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.glb import RefScene
from portbench.reference.intersect import any_hit

PI = 3.1415926535
MIN_ROUGHNESS = 0.05
F0_FLOOR = 0.01
LOG2_MIN, LOG2_MAX = -8.0, 40.0
# the visibility ray (RtxdiApplicationBridge.glsl:191-217): from the
# surface, t from 0.001 to the sample's distance less 0.002
VIS_OFFSET = 0.001


class Lights(NamedTuple):
    v0: torch.Tensor  # [L, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    radiance: torch.Tensor  # [L, 3] as the light record stores it
    normal: torch.Tensor  # [L, 3] the emitting side
    area: torch.Tensor  # [L]


class Shading(NamedTuple):
    """Per point: the world position, the unit normal, the unit direction
    to the viewer, albedo, F0 [n, 3] and roughness [n]."""

    pos: torch.Tensor
    normal: torch.Tensor
    view: torch.Tensor
    albedo: torch.Tensor
    f0: torch.Tensor
    roughness: torch.Tensor

    def to(self, dtype) -> "Shading":
        return Shading(*(x.to(dtype) for x in self))


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(v):
    return v / torch.clamp_min(torch.sqrt(_dot(v, v)), 1e-20)[..., None]


def stored_radiance(radiance: torch.Tensor) -> torch.Tensor:
    """[L, 3] float32 radiance as a light record keeps it: the largest
    channel rounded up to a step of a 16-bit log2 scale over [2^-8, 2^40]
    (0 meaning none), the colour over it as 8-bit unorms."""
    intensity = radiance.amax(-1)
    log_r = torch.clamp((torch.log2(torch.clamp_min(intensity, 1e-30))
                         - LOG2_MIN) / (LOG2_MAX - LOG2_MIN), 0.0, 1.0)
    code = torch.clamp_max(torch.ceil(log_r * 65534.0).long() + 1, 0xFFFF)
    scale = torch.exp2((code.float() - 1.0) / 65534.0
                       * (LOG2_MAX - LOG2_MIN) + LOG2_MIN)
    colour = torch.clamp(radiance / torch.clamp_min(scale, 1e-30)[:, None],
                         0.0, 1.0)
    colour = torch.floor(colour * 255.0 + 0.5) / 255.0
    return torch.where((intensity > 0.0)[:, None], colour * scale[:, None],
                       0.0)


def triangle_lights(scene: RefScene) -> Lights:
    """The scene's emissive triangles in scene order, which is the light
    buffer's (prepare_lights.rs:182-209): light index i is the i-th."""
    sel = torch.nonzero((scene.emission != 0.0).any(-1))[:, 0]
    e1, e2 = scene.e1[sel], scene.e2[sel]
    c = _cross(e1, e2)
    length = torch.sqrt(_dot(c, c))
    return Lights(v0=scene.v0[sel], e1=e1, e2=e2,
                  radiance=stored_radiance(scene.emission[sel]),
                  normal=c / torch.clamp_min(length, 1e-30)[:, None],
                  area=0.5 * length)


def brdf(s: Shading, to_light: torch.Tensor):
    """(Lambert over pi [n], GGX specular times N.L [n, 3]) toward the
    unit directions `to_light` (EvaluateBrdf, bridge:146-159)."""
    lam = torch.clamp_min(_dot(s.normal, to_light), 0.0) / PI
    r = torch.clamp_min(s.roughness, MIN_ROUGHNESS)
    h = _unit(to_light + s.view)
    nol = torch.clamp(_dot(s.normal, to_light), 0.0, 1.0)
    voh = torch.clamp(_dot(s.view, h), 0.0, 1.0)
    nov = torch.clamp(_dot(s.normal, s.view), 0.0, 1.0)
    noh = torch.clamp(_dot(s.normal, h), 0.0, 1.0)
    alpha = r * r
    a2 = alpha * alpha
    g = 2.0 * nol / torch.clamp_min(
        nov * torch.sqrt(a2 + (1.0 - a2) * nol * nol)
        + nol * torch.sqrt(a2 + (1.0 - a2) * nov * nov), 1e-20)
    a = noh * noh * alpha * alpha
    b = 1.0 - noh * noh
    d = (alpha * alpha) / (PI * (a + b * a + b))  # square(a + b), unbracketed
    fresnel = s.f0 + (1.0 - s.f0) * torch.pow(
        torch.clamp_min(1.0 - voh, 0.0), 5.0)[:, None]
    spec = fresnel * (d * g / 4.0)[:, None]
    spec = torch.where(((nol > 0.0) & (s.roughness != 0.0))[:, None], spec,
                       0.0)
    return lam, spec


def visible(scene: RefScene, pos: torch.Tensor, target: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """[n] bool: nothing lies between each point and its target."""
    l = target - pos
    dist = torch.sqrt(_dot(l, l))
    d = l / torch.clamp_min(dist, 1e-30)[:, None]
    t_min = torch.full_like(dist, VIS_OFFSET)
    t_max = torch.clamp_min(dist - 2.0 * VIS_OFFSET, VIS_OFFSET)
    return ~any_hit(scene, pos, d, t_min, t_max, dtype)


def sample_point(lights: Lights, index: torch.Tensor, uv: torch.Tensor
                 ) -> torch.Tensor:
    """The point a light sample's uv names on its triangle
    (Helpers.glsl:66-74's square-root warp)."""
    su = torch.sqrt(uv[:, 0])
    b1 = (su * (1.0 - uv[:, 1]))[:, None]
    b2 = (su * uv[:, 1])[:, None]
    return lights.v0[index] + lights.e1[index] * b1 + lights.e2[index] * b2


def shade_sample(scene: RefScene, lights: Lights, s: Shading,
                 index: torch.Tensor, uv: torch.Tensor, weight: torch.Tensor,
                 with_visibility: bool, dtype=torch.float32):
    """(demodulated diffuse, demodulated specular) [n, 3] of shading each
    point with light `index` at `uv` and the reservoir's inverse pdf
    `weight`; 0 where the index is no local light (the scenes have no
    environment map)."""
    local = (index >= 0) & (index < lights.v0.shape[0])
    i = torch.where(local, index, 0)
    lt = Lights(*(x.to(dtype) for x in lights))
    s = s.to(dtype)
    y = sample_point(lt, i, uv.to(dtype))
    l = y - s.pos
    dist = torch.sqrt(_dot(l, l))
    to_light = l / torch.clamp_min(dist, 1e-20)[:, None]
    cos_l = torch.clamp(-_dot(to_light, lt.normal[i]), 0.0, 1.0)
    pdf = (1.0 / torch.clamp_min(lt.area[i], 1e-20)) * (dist * dist) \
        / torch.clamp_min(cos_l, 1e-20)
    radiance = lt.radiance[i]
    if with_visibility:
        radiance = radiance * visible(scene, s.pos, y, dtype)[:, None]
    radiance = radiance * (weight.to(dtype) / torch.clamp_min(pdf, 1e-30)
                           )[:, None]
    lit = local & (radiance > 0.0).any(-1)
    lam, spec = brdf(s, to_light)
    diffuse = torch.where(lit[:, None], lam[:, None] * radiance, 0.0)
    specular = torch.where(lit[:, None], spec * radiance, 0.0)
    specular = specular / torch.clamp_min(s.f0, F0_FLOOR)
    return diffuse.float(), specular.float()


def _centroids(sub: int, device, dtype) -> torch.Tensor:
    """[sub^2, 2] barycentric (b1, b2) of the centroids of the sub^2 equal
    triangles that split a triangle into sub x sub."""
    pts = []
    for i in range(sub):
        for j in range(sub - i):
            pts.append(((i + 1 / 3) / sub, (j + 1 / 3) / sub))
            if i + j <= sub - 2:
                pts.append(((i + 2 / 3) / sub, (j + 2 / 3) / sub))
    return torch.tensor(pts, dtype=dtype, device=device)


def many_light(scene: RefScene, lights: Lights, s: Shading, sub: int,
               dtype=torch.float32, block: int = 64) -> torch.Tensor:
    """[n, 3] float32 reflected radiance (albedo x diffuse + specular) of
    the direct light of every emissive triangle at each point: each
    triangle split into sub^2 equal parts, each part's light taken at its
    centroid, with brute-force visibility. Points go in blocks of `block`;
    each block's sum over the lights accumulates in `dtype`."""
    n = s.pos.shape[0]
    dev = s.pos.device
    lt = Lights(*(x.to(dtype) for x in lights))
    c = _centroids(sub, dev, dtype)
    y = (lt.v0[:, None] + lt.e1[:, None] * c[None, :, 0:1]
         + lt.e2[:, None] * c[None, :, 1:2]).reshape(-1, 3)  # [L*q, 3]
    q = c.shape[0]
    le = lt.radiance.repeat_interleave(q, 0)
    nl = lt.normal.repeat_interleave(q, 0)
    da = (lt.area / (sub * sub)).repeat_interleave(q, 0)
    out = torch.zeros((n, 3), dtype=dtype, device=dev)
    for p0 in range(0, n, block):
        sp = Shading(*(x[p0:p0 + block].to(dtype) for x in s))
        b = sp.pos.shape[0]
        pos = sp.pos[:, None].expand(b, y.shape[0], 3).reshape(-1, 3)
        tgt = y[None].expand(b, -1, -1).reshape(-1, 3)
        l = tgt - pos
        dist2 = _dot(l, l)
        to_light = l / torch.clamp_min(torch.sqrt(dist2), 1e-20)[:, None]
        cos_l = torch.clamp(-_dot(to_light, nl.repeat(b, 1)), 0.0, 1.0)
        rep = Shading(*(x.repeat_interleave(y.shape[0], 0) for x in sp))
        lam, spec = brdf(rep, to_light)
        geo = cos_l * da.repeat(b) / torch.clamp_min(dist2, 1e-20)
        term = (rep.albedo * lam[:, None] + spec) * (le.repeat(b, 1)
                                                      * geo[:, None])
        # visibility only where light arrives
        live = (term > 0.0).any(-1)
        vis = torch.zeros_like(live)
        idx = torch.nonzero(live)[:, 0]
        if idx.numel():
            vis[idx] = visible(scene, pos[idx], tgt[idx], dtype)
        term = torch.where(vis[:, None], term, 0.0).reshape(b, -1, 3)
        acc = torch.zeros((b, 3), dtype=dtype, device=dev)
        for l0 in range(0, term.shape[1], 4096):
            acc = acc + term[:, l0:l0 + 4096].sum(1).to(dtype)
        out[p0:p0 + block] = acc
    return out.float()
