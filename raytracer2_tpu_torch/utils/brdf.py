"""Sampling / BRDF / spherical-geometry helpers, port of
raytracer2_tpu/utils/brdf.py (src/shaders/Helpers.glsl, common.glsl;
vectors in a trailing dim of 3, broadcasting over leading dims).

GGX_MACRO_QUIRK keeps the reference's unparenthesized `square` macro in
the GGX D denominator (common.glsl:2, Helpers.glsl:189/226), as the JAX
package does. Luminance is the app shaders' Rec.601 variant; the
resampling library's Rec.709 one is luminance_rec709.
"""

from __future__ import annotations

import torch

PI = 3.1415926535  # RTXDI_PI (rtxdi/RtxdiMath.hlsli:14)
K_MIN_ROUGHNESS = 0.05  # kMinRoughness (common.glsl:3)

GGX_MACRO_QUIRK = True


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the trailing dim, summed in index order."""
    return torch.sqrt(dot3(v, v))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp_min(length(v), eps)[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """GLSL reflect: I - 2*dot(N,I)*N."""
    return incident - 2.0 * dot3(normal, incident)[..., None] * normal


def saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.601 luminance used by app shaders (ref: Helpers.glsl:94-97)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=color.dtype,
                     device=color.device)
    return (color * w).sum(dim=-1)


def luminance_rec709(color: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of the resampling library (RtxdiMath.hlsli:120-123)."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=color.dtype,
                     device=color.device)
    return (color * w).sum(dim=-1)


def sample_triangle(rnd: torch.Tensor) -> torch.Tensor:
    """[..., 2] uniforms -> [..., 3] barycentrics (ref: Helpers.glsl:66-74)."""
    sqrtx = torch.sqrt(rnd[..., 0])
    return torch.stack([1.0 - sqrtx, sqrtx * (1.0 - rnd[..., 1]),
                        sqrtx * rnd[..., 1]], dim=-1)


def hit_uv_to_barycentric(uv: torch.Tensor) -> torch.Tensor:
    """[..., 2] hit attribs -> [..., 3] barycentrics (ref: Helpers.glsl:76-79)."""
    return torch.stack([1.0 - uv[..., 0] - uv[..., 1], uv[..., 0],
                        uv[..., 1]], dim=-1)


def random_from_barycentric(bary: torch.Tensor) -> torch.Tensor:
    """Inverse of sample_triangle (ref: Helpers.glsl:81-86)."""
    sqrtx = 1.0 - bary[..., 0]
    return torch.stack([sqrtx * sqrtx,
                        bary[..., 2] / torch.clamp_min(sqrtx, 1e-20)], dim=-1)


def pdf_area_to_solid_angle(pdf_a, distance, cos_theta):
    """Area-measure pdf -> solid-angle-measure (ref: Helpers.glsl:88-92)."""
    return pdf_a * (distance * distance) / cos_theta


def sample_disk(random: torch.Tensor) -> torch.Tensor:
    """[..., 2] uniforms -> [..., 2] point on unit disk (ref: Helpers.glsl:122-126)."""
    angle = 2.0 * PI * random[..., 0]
    r = torch.sqrt(random[..., 1])
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1) \
        * r[..., None]


def sample_cos_hemisphere(random: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 2] uniforms -> (dir [...,3] in tangent space, pdf)
    (ref: Helpers.glsl:171-179)."""
    tangential = sample_disk(random)
    elevation = torch.sqrt(saturate(1.0 - random[..., 1]))
    pdf = elevation / PI
    return torch.cat([tangential, elevation[..., None]], dim=-1), pdf


def sample_sphere(rand: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 2] uniforms -> (unit dir, pdf=1/4pi) (ref: Helpers.glsl:347-359)."""
    y = rand[..., 1] * 2.0 - 1.0
    tangential = sample_disk(torch.stack([rand[..., 0], 1.0 - y * y], dim=-1))
    dirs = torch.cat([tangential, y[..., None]], dim=-1)
    return dirs, torch.full_like(y, 0.25 / PI)


def construct_onb(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless ONB; returns (tangent, bitangent) (ref: Helpers.glsl:112-119)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = torch.stack(
        [1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bitangent = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return tangent, bitangent


def world_to_tangent(normal: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """World dir -> tangent space; basis order (bitangent, tangent, normal)
    (ref: RtxdiApplicationBridge.glsl:106-116)."""
    tangent, bitangent = construct_onb(normal)
    return torch.stack(
        [dot3(bitangent, w), dot3(tangent, w), dot3(normal, w)], dim=-1)


def tangent_to_world(normal: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Tangent space dir -> world (ref: RtxdiApplicationBridge.glsl:118-128)."""
    tangent, bitangent = construct_onb(normal)
    return (bitangent * h[..., 0:1] + tangent * h[..., 1:2]
            + normal * h[..., 2:3])


def ggx_d(noh: torch.Tensor, alpha: torch.Tensor,
          quirk: bool | None = None) -> torch.Tensor:
    """GGX normal distribution D(h) (ref: Helpers.glsl:226, 189); quirk
    reproduces the macro expansion a + b*a + b of `square(a + b)`."""
    if quirk is None:
        quirk = GGX_MACRO_QUIRK
    a = noh * noh * alpha * alpha
    b = 1.0 - noh * noh
    denom = a + b * a + b if quirk else (a + b) * (a + b)
    return (alpha * alpha) / (PI * denom)


def importance_sample_ggx(random: torch.Tensor, roughness: torch.Tensor
                          ) -> torch.Tensor:
    """Classic NDF sampling: the half vector in tangent space
    (ref: Helpers.glsl:128-142)."""
    alpha = roughness * roughness
    phi = 2.0 * PI * random[..., 0]
    cos_theta = torch.sqrt((1.0 - random[..., 1])
                           / (1.0 + (alpha * alpha - 1.0) * random[..., 1]))
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def importance_sample_ggx_vndf(random: torch.Tensor, roughness: torch.Tensor,
                               ve: torch.Tensor,
                               ndf_trim: float = 1.0) -> torch.Tensor:
    """Visible-NDF sampling (Heitz); ve is the view dir in tangent space,
    returns the (unnormalized) half-vector in tangent space
    (ref: Helpers.glsl:144-169)."""
    alpha = (roughness * roughness)[..., None]
    vh = normalize(torch.cat(
        [alpha * ve[..., 0:1], alpha * ve[..., 1:2], ve[..., 2:3]], dim=-1))

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1_safe = (torch.stack([-vh[..., 1], vh[..., 0],
                            torch.zeros_like(lensq)], dim=-1)
               / torch.sqrt(torch.clamp_min(lensq, 1e-30))[..., None])
    t1_fallback = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype,
                               device=vh.device).expand(vh.shape)
    t1 = torch.where((lensq > 0.0)[..., None], t1_safe, t1_fallback)
    t2 = cross(vh, t1)

    r = torch.sqrt(random[..., 0] * ndf_trim)
    phi = 2.0 * PI * random[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2

    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0)
                       )[..., None] * vh)

    return torch.cat(
        [alpha * nh[..., 0:1], alpha * nh[..., 1:2],
         torch.clamp_min(nh[..., 2:3], 0.0)], dim=-1)


def importance_sample_ggx_vndf_pdf(roughness, n, v, l, quirk=None):
    """Solid-angle pdf of VNDF sampling (ref: Helpers.glsl:182-191)."""
    h = normalize(l + v)
    noh = saturate(dot3(n, h))
    voh = saturate(dot3(v, h))
    alpha = roughness * roughness
    d = ggx_d(noh, alpha, quirk)
    return torch.where(voh > 0.0, d / (4.0 * voh), 0.0)


def schlick_fresnel(f0: torch.Tensor, voh: torch.Tensor) -> torch.Tensor:
    """Schlick approximation; f0 scalar-shaped or [...,3]
    (ref: Helpers.glsl:194-202)."""
    p = torch.pow(torch.clamp_min(1.0 - voh, 0.0), 5.0)
    if f0.dim() == voh.dim() + 1:
        p = p[..., None]
    return f0 + (1.0 - f0) * p


def g_smith_over_ndotv(roughness, ndotv, ndotl):
    """Height-correlated Smith G / NdotV (ref: Helpers.glsl:205-211)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    g1 = ndotv * torch.sqrt(a2 + (1.0 - a2) * ndotl * ndotl)
    g2 = ndotl * torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv)
    return 2.0 * ndotl / torch.clamp_min(g1 + g2, 1e-20)


def g1_smith(roughness, ndotl):
    """Smith masking for a single direction (ref: Helpers.glsl:305-309)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    return 2.0 * ndotl / (ndotl + torch.sqrt(a2 + (1.0 - a2) * ndotl * ndotl))


def ggx_times_ndotl(v, l, n, roughness, f0, quirk=None) -> torch.Tensor:
    """Full specular BRDF * NdotL, [...,3] (ref: Helpers.glsl:213-233)."""
    h = normalize(l + v)
    nol = saturate(dot3(n, l))
    voh = saturate(dot3(v, h))
    nov = saturate(dot3(n, v))
    noh = saturate(dot3(n, h))
    g = g_smith_over_ndotv(roughness, nov, nol)
    d = ggx_d(noh, roughness * roughness, quirk)
    spec = schlick_fresnel(f0, voh) * (d * g / 4.0)[..., None]
    return torch.where((nol > 0.0)[..., None], spec, 0.0)


def lambert(normal: torch.Tensor, light_incident: torch.Tensor
            ) -> torch.Tensor:
    """Lambert term of an incident dir (ref: Helpers.glsl:236-239)."""
    return torch.clamp_min(-dot3(normal, light_incident), 0.0) / PI


def demodulate_specular(specular_f0: torch.Tensor, specular: torch.Tensor
                        ) -> torch.Tensor:
    """(ref: Helpers.glsl:312-315)."""
    return specular / torch.clamp_min(specular_f0, 0.01)


def direction_to_equirect_uv(direction: torch.Tensor) -> torch.Tensor:
    """Unit dir -> equirect uv in [0,1]^2 (ref: Helpers.glsl:242-248)."""
    u = 0.5 + torch.atan2(direction[..., 2], direction[..., 0]) / (2.0 * PI)
    v = 0.5 - torch.asin(torch.clamp(direction[..., 1], -1.0, 1.0)) / PI
    return torch.stack([u, v], dim=-1)


def equirect_uv_to_direction(uv: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """uv -> (unit dir, cos(elevation)) (ref: Helpers.glsl:334-345)."""
    azimuth = (uv[..., 0] + 0.25) * (2.0 * PI)
    elevation = (0.5 - uv[..., 1]) * PI
    cos_el = torch.cos(elevation)
    d = torch.stack([torch.cos(azimuth) * cos_el, torch.sin(elevation),
                     torch.sin(azimuth) * cos_el], dim=-1)
    return d, cos_el


def basic_tone_mapping(color: torch.Tensor, bias) -> torch.Tensor:
    """Reinhard-style luminance mapping (ref: Helpers.glsl:99-110)."""
    lum = luminance(color)
    new_lum = lum / (bias + lum)
    scale = torch.where(lum > 0.0, new_lum / torch.clamp_min(lum, 1e-20),
                        1.0)
    return color * scale[..., None]


def cartesian_to_spherical(v: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(r, azimuth, elevation) (ref: RtxdiMath.hlsli:81-88)."""
    r = torch.linalg.vector_norm(v, dim=-1)
    n = v / torch.clamp_min(r, 1e-30)[..., None]
    azimuth = torch.atan2(n[..., 2], n[..., 0])
    elevation = torch.asin(torch.clamp(n[..., 1], -1.0, 1.0))
    return r, azimuth, elevation


def spherical_to_cartesian(r: torch.Tensor, azimuth: torch.Tensor,
                           elevation: torch.Tensor) -> torch.Tensor:
    """(ref: RtxdiMath.hlsli:90-101)."""
    cos_el = torch.cos(elevation)
    return torch.stack([r * torch.cos(azimuth) * cos_el,
                        r * torch.sin(elevation),
                        r * torch.sin(azimuth) * cos_el], dim=-1)
