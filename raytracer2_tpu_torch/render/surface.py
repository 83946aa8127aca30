"""RAB_Surface and the scene-access bridge functions, port of
raytracer2_tpu/render/surface.py (RtxdiApplicationBridge.glsl): surfaces
from hits, BRDF sampling, pdf and evaluation, material similarity and the
view clamp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.ops.intersect import HitRecord
from raytracer2_tpu_torch.params import BACKGROUND_DEPTH
from raytracer2_tpu_torch.restir.helpers import compare_relative_difference
from raytracer2_tpu_torch.scene.scene import Scene, get_geometry_from_hit
from raytracer2_tpu_torch.utils import brdf
from raytracer2_tpu_torch.utils import rng as rtrng


class Surface(NamedTuple):
    """RAB_Surface (ref: RtxdiApplicationBridge.glsl:83-94), SoA over pixels."""

    world_pos: torch.Tensor  # [..., 3]
    view_dir: torch.Tensor  # [..., 3]
    view_depth: torch.Tensor  # [...]
    normal: torch.Tensor  # [..., 3]
    geo_normal: torch.Tensor  # [..., 3]
    diffuse_albedo: torch.Tensor  # [..., 3]
    specular_f0: torch.Tensor  # [..., 3]
    roughness: torch.Tensor  # [...]
    diffuse_probability: torch.Tensor  # [...]

    @property
    def valid(self) -> torch.Tensor:
        """RAB_IsSurfaceValid (bridge:347-350)."""
        return self.view_depth != BACKGROUND_DEPTH


def empty_surface(shape, *, device, dtype=torch.float32) -> Surface:
    """RAB_EmptySurface (bridge:161-166): zeros, view_depth =
    BACKGROUND_DEPTH."""
    shape = tuple(shape)
    v3 = torch.zeros(shape + (3,), dtype=dtype, device=device)
    v1 = torch.zeros(shape, dtype=dtype, device=device)
    return Surface(
        world_pos=v3, view_dir=v3,
        view_depth=torch.full(shape, BACKGROUND_DEPTH, dtype=dtype,
                              device=device),
        normal=v3, geo_normal=v3, diffuse_albedo=v3, specular_f0=v3,
        roughness=v1, diffuse_probability=v1)


def get_surface_diffuse_probability(surface_albedo, specular_f0, view_dir,
                                    normal) -> torch.Tensor:
    """Bridge getSurfaceDiffuseProbability is hardcoded to 1.0 — the
    weighted version is commented out (bridge:131-138). Quirk preserved."""
    return torch.ones(surface_albedo.shape[:-1], dtype=surface_albedo.dtype,
                      device=surface_albedo.device)


def surface_from_hit(scene: Scene, ray_origin: torch.Tensor,
                     ray_direction: torch.Tensor, hit: HitRecord,
                     textures_enabled: bool = True
                     ) -> tuple[Surface, torch.Tensor]:
    """Port of GetSurface (Hit.glsl:44-70): a Surface + emission from a hit
    record. Missed lanes produce an invalid surface and zero emission."""
    missed = hit.missed
    attribs = torch.stack([hit.u, hit.v], dim=-1)
    geom = get_geometry_from_hit(
        scene, hit.geometry_index, hit.primitive_id, attribs,
        textures_enabled=textures_enabled,
        triangle_index=hit.triangle_index)

    world_pos = ray_origin + ray_direction * hit.t[..., None]
    depth = torch.where(missed, BACKGROUND_DEPTH, hit.t)
    diffuse_prob = get_surface_diffuse_probability(
        geom.diffuse_albedo, geom.specular_f0, ray_direction, geom.normal)

    surface = Surface(
        world_pos=world_pos,
        view_dir=ray_direction,  # Hit.glsl:68 stores the ray direction
        view_depth=depth,
        normal=geom.normal,
        geo_normal=geom.normal,  # geoNormal = normal (Hit.glsl:66 quirk)
        diffuse_albedo=geom.diffuse_albedo,
        specular_f0=geom.specular_f0,
        roughness=geom.roughness,
        diffuse_probability=diffuse_prob,
    )
    emission = torch.where(missed[..., None], 0.0, geom.emission)
    return surface, emission


def get_surface_brdf_sample(surface: Surface, state: rtrng.RngState
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       rtrng.RngState]:
    """Port of RAB_GetSurfaceBrdfSample (bridge:437-461): draws 3 uniforms,
    picks the cosine lobe with diffuse_probability, else GGX-VNDF
    reflection. Returns (direction, valid_mask, new_state)."""
    rand, state = rtrng.sample_uniform_n(state, 3)
    use_diffuse = rand[..., 0] < surface.diffuse_probability

    h_diff, _ = brdf.sample_cos_hemisphere(rand[..., 1:3])
    dir_diffuse = brdf.tangent_to_world(surface.normal, h_diff)

    ve = brdf.normalize(brdf.world_to_tangent(surface.normal,
                                              surface.view_dir))
    h_spec = brdf.importance_sample_ggx_vndf(
        rand[..., 1:3],
        torch.clamp_min(surface.roughness, brdf.K_MIN_ROUGHNESS), ve, 1.0)
    h_spec = brdf.normalize(h_spec)
    dir_specular = brdf.reflect(
        -surface.view_dir, brdf.tangent_to_world(surface.normal, h_spec))

    direction = torch.where(use_diffuse[..., None], dir_diffuse, dir_specular)
    valid = brdf.dot3(surface.normal, direction) > 0.0
    return direction, valid, state


def get_surface_brdf_pdf(surface: Surface, direction: torch.Tensor
                         ) -> torch.Tensor:
    """Port of RAB_GetSurfaceBrdfPdf (bridge:463-470)."""
    cos_theta = brdf.saturate(brdf.dot3(surface.normal, direction))
    diffuse_pdf = cos_theta / brdf.PI
    specular_pdf = brdf.importance_sample_ggx_vndf_pdf(
        torch.clamp_min(surface.roughness, brdf.K_MIN_ROUGHNESS),
        surface.normal, surface.view_dir, direction)
    pdf = (specular_pdf
           + (diffuse_pdf - specular_pdf) * surface.diffuse_probability)
    return torch.where(cos_theta > 0.0, pdf, 0.0)


class SplitBrdf(NamedTuple):
    """(ref: bridge:140-144)."""

    demodulated_diffuse: torch.Tensor  # [...]
    specular: torch.Tensor  # [..., 3]


def evaluate_brdf(surface: Surface, sample_position: torch.Tensor
                  ) -> SplitBrdf:
    """Port of EvaluateBrdf (bridge:146-159)."""
    l = brdf.normalize(sample_position - surface.world_pos)
    demod_diffuse = brdf.lambert(surface.normal, -l)
    spec = brdf.ggx_times_ndotl(
        surface.view_dir, l, surface.normal,
        torch.clamp_min(surface.roughness, brdf.K_MIN_ROUGHNESS),
        surface.specular_f0)
    spec = torch.where((surface.roughness == 0.0)[..., None], 0.0, spec)
    return SplitBrdf(demodulated_diffuse=demod_diffuse, specular=spec)


def are_materials_similar(a: Surface, b: Surface) -> torch.Tensor:
    """Port of RAB_AreMaterialsSimilar (bridge:600-616)."""
    ok = compare_relative_difference(a.roughness, b.roughness, 0.5)
    ok &= (torch.abs(brdf.luminance(a.specular_f0)
                     - brdf.luminance(b.specular_f0)) <= 0.25)
    ok &= (torch.abs(brdf.luminance(a.diffuse_albedo)
                     - brdf.luminance(b.diffuse_albedo)) <= 0.25)
    return ok


def clamp_sample_position_into_view(px, py, width: int, height: int):
    """Port of RAB_ClampSamplePositionIntoView (bridge:252-265): reflect
    off-screen positions across the nearest edge."""
    px = torch.where(px < 0, -px, px)
    py = torch.where(py < 0, -py, py)
    px = torch.where(px >= width, 2 * width - px - 1, px)
    py = torch.where(py >= height, 2 * height - py - 1, py)
    return px, py
