"""Sampling / BRDF helpers, port of the part of raytracer2_tpu/utils/brdf.py
that the reference path tracer and the scene's environment lookup call
(vectors in a trailing dim of 3, broadcasting over leading dims).

GGX_MACRO_QUIRK keeps the reference's unparenthesized `square` macro in
the GGX D denominator (common.glsl:2, Helpers.glsl:189/226), as the JAX
package does; the DI slice's BRDF evaluation and pdf read it. The rest of
the module (luminance, Schlick/Smith terms, sphere/triangle sampling)
comes with that slice (ROADMAP queue A).
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


def direction_to_equirect_uv(direction: torch.Tensor) -> torch.Tensor:
    """Unit dir -> equirect uv in [0,1]^2 (ref: Helpers.glsl:242-248)."""
    u = 0.5 + torch.atan2(direction[..., 2], direction[..., 0]) / (2.0 * PI)
    v = 0.5 - torch.asin(torch.clamp(direction[..., 1], -1.0, 1.0)) / PI
    return torch.stack([u, v], dim=-1)
