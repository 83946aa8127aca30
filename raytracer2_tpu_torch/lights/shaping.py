"""Spot-light shaping, port of raytracer2_tpu/lights/shaping.py
(src/shaders/LightShaping.glsl).

The reference packs cone axis, angle and softness into the light record's
shaping words, stubs its IES lookup to 1.0 and never creates a shaped
light; the cone falloff is implemented and evaluates to 1.0 for every
light the prepare pass emits. uint32 words are int64 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.utils import brdf
from raytracer2_tpu_torch.utils import packing as pk

# flag bits in colorTypeAndFlags (ShaderParameters.glsl:16-17)
K_SHAPING_ENABLE_BIT = 1 << 28
K_IES_PROFILE_ENABLE_BIT = 1 << 29


class LightShaping(NamedTuple):
    """(ref: LightShaping.glsl struct)."""

    is_spot: torch.Tensor  # [...] bool
    primary_axis: torch.Tensor  # [..., 3]
    cos_cone_angle: torch.Tensor  # [...]
    cone_softness: torch.Tensor  # [...]
    ies_profile_index: torch.Tensor  # [...] int32 (-1 none)


def unpack_light_shaping(color_type_and_flags, primary_axis_packed,
                         cos_cone_angle_and_softness, ies_profile_index
                         ) -> LightShaping:
    """(ref: LightShaping.glsl:16-25)."""
    is_spot = (color_type_and_flags & K_SHAPING_ENABLE_BIT) != 0
    has_ies = (color_type_and_flags & K_IES_PROFILE_ENABLE_BIT) != 0
    return LightShaping(
        is_spot=is_spot,
        primary_axis=pk.oct_unorm32_to_ndir(primary_axis_packed),
        cos_cone_angle=pk.f16_bits_to_f32(cos_cone_angle_and_softness),
        cone_softness=pk.f16_bits_to_f32(cos_cone_angle_and_softness >> 16),
        ies_profile_index=torch.where(has_ies,
                                      ies_profile_index.to(torch.int32), -1))


def evaluate_ies_profile(profile_index, direction: torch.Tensor
                         ) -> torch.Tensor:
    """IES lookup, stubbed to 1.0 as in the reference
    (LightShaping.glsl:27-54)."""
    return torch.ones(direction.shape[:-1], dtype=direction.dtype,
                      device=direction.device)


def evaluate_light_shaping(shaping: LightShaping, surface_pos: torch.Tensor,
                           light_sample_pos: torch.Tensor) -> torch.Tensor:
    """Smoothstep cone falloff (ref: LightShaping.glsl:56-75)."""
    to_surface = brdf.normalize(surface_pos - light_sample_pos)
    cos_theta = brdf.dot3(shaping.primary_axis, to_surface)
    edge0 = shaping.cos_cone_angle
    edge1 = shaping.cos_cone_angle + shaping.cone_softness
    t = torch.clamp((cos_theta - edge0)
                    / torch.clamp_min(edge1 - edge0, 1e-6), 0.0, 1.0)
    falloff = t * t * (3.0 - 2.0 * t)
    falloff = falloff * evaluate_ies_profile(shaping.ies_profile_index,
                                             to_surface)
    return torch.where(shaping.is_spot, falloff, 1.0)


def get_shaping_flux_factor(shaping: LightShaping) -> torch.Tensor:
    """Approximate cone flux fraction: unshaped lights keep full flux."""
    frac = (1.0 - shaping.cos_cone_angle) * 0.5
    return torch.where(shaping.is_spot, frac, 1.0)


def sphere_intersects_shaped_light(light_pos: torch.Tensor, light_radius,
                                   shaping: LightShaping,
                                   volume_center: torch.Tensor,
                                   volume_radius) -> torch.Tensor:
    """Sphere-vs-cone culling (ref: LightShaping.glsl:~130; the JAX
    package's test_sphere_intersection_for_shaped_light): a conservative
    accept for unshaped lights, the cone widened by the volume's angular
    radius for spots."""
    to_volume = volume_center - light_pos
    dist = torch.linalg.vector_norm(to_volume, dim=-1)
    cos_to_volume = brdf.dot3(
        shaping.primary_axis,
        to_volume / torch.clamp_min(dist, 1e-20)[..., None])
    sin_ang = torch.clamp(volume_radius / torch.clamp_min(dist, 1e-20),
                          0.0, 1.0)
    cos_expanded = (shaping.cos_cone_angle * torch.sqrt(1.0 - sin_ang ** 2)
                    - torch.sqrt(torch.clamp_min(
                        1.0 - shaping.cos_cone_angle ** 2, 0.0)) * sin_ang)
    inside = cos_to_volume >= cos_expanded
    return torch.where(shaping.is_spot, inside | (dist <= volume_radius),
                       torch.ones_like(inside))
