"""Shading glue: light-sample shading and output accumulation, port of
raytracer2_tpu/render/shading.py (src/shaders/ShadingHelpers.glsl). The
final visibility ray inside ShadeSurfaceWithLightSample
(ShadingHelpers.glsl:34-38) is one batched occlusion query through the
bridge.
"""

from __future__ import annotations

import torch

from raytracer2_tpu_torch.lights.polymorphic import LightSample
from raytracer2_tpu_torch.params import (
    DIShadingParameters, DITemporalResamplingParameters)
from raytracer2_tpu_torch.render.surface import Surface, evaluate_brdf
from raytracer2_tpu_torch.restir import di_reservoir as dires
from raytracer2_tpu_torch.restir.bridge import Bridge


def setup_visibility_ray(surface: Surface, sample_position: torch.Tensor,
                         offset: float = 0.001):
    """(RtxdiApplicationBridge.glsl:191-217). Returns (origin, dir, tmin,
    tmax)."""
    l = sample_position - surface.world_pos
    dist = torch.linalg.vector_norm(l, dim=-1)
    direction = l / torch.clamp_min(dist, 1e-30)[..., None]
    t_min = torch.full_like(dist, offset)
    t_max = torch.clamp_min(dist - offset * 2.0, offset)
    return surface.world_pos, direction, t_min, t_max


def shade_surface_with_light_sample(
    reservoir: dires.DIReservoir,
    surface: Surface,
    light_sample: LightSample,
    shading_params: DIShadingParameters,
    temporal_params: DITemporalResamplingParameters,
    bridge: Bridge,
    enable_visibility_reuse: bool,
    known_visibility: torch.Tensor | None = None,
) -> tuple[dires.DIReservoir, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Port of ShadeSurfaceWithLightSample (ShadingHelpers.glsl:2-58).

    known_visibility: an earlier get_conservative_visibility(surface,
    light_sample.position) of the same sample in this pass (the fused DI
    pass's initial-visibility ray, with no resampling in between); it
    stands in for the shading ray, which would trace the same rays.
    Returns (reservoir, diffuse [...,3], specular [...,3], light_distance)."""
    shape = surface.view_depth.shape
    dev = surface.view_depth.device
    live = light_sample.solid_angle_pdf > 0.0
    radiance = light_sample.radiance

    if shading_params.enable_final_visibility:
        if shading_params.reuse_final_visibility and enable_visibility_reuse:
            reused, vis = dires.get_reservoir_visibility(
                reservoir, shading_params.final_visibility_max_age,
                shading_params.final_visibility_max_distance)
        else:
            reused = torch.zeros(shape, dtype=torch.bool, device=dev)
            vis = torch.zeros(shape + (3,), device=dev)
        # one batched visibility ray for lanes without reusable visibility
        visible = known_visibility
        if visible is None:
            visible = bridge.get_conservative_visibility(
                surface, light_sample.position)
        traced_vis = torch.where(visible[..., None], 1.0, 0.0)
        need_trace = live & ~reused
        vis = torch.where(need_trace[..., None], traced_vis, vis)
        reservoir = dires.store_visibility(
            reservoir, vis, bool(temporal_params.discard_invisible_samples),
            active=need_trace)
        radiance = radiance * vis

    radiance = radiance * (dires.inv_pdf(reservoir)
                           / torch.clamp_min(light_sample.solid_angle_pdf,
                                             1e-30))[..., None]

    lit = live & (radiance > 0.0).any(dim=-1)
    brdf = evaluate_brdf(surface, light_sample.position)
    diffuse = torch.where(lit[..., None],
                          brdf.demodulated_diffuse[..., None] * radiance, 0.0)
    specular = torch.where(lit[..., None], brdf.specular * radiance, 0.0)
    light_distance = torch.where(
        lit, torch.linalg.vector_norm(light_sample.position
                                      - surface.world_pos, dim=-1), 0.0)
    return reservoir, diffuse, specular, light_distance


def store_shading_output(
    diffuse_img: torch.Tensor,  # [H, W, 3] prior
    specular_img: torch.Tensor,
    diffuse: torch.Tensor,  # [H, W, 3] new contribution
    specular: torch.Tensor,
    is_first_pass: bool,
    enable_accumulation: int,
    blend_factor: float,
    write_mask: torch.Tensor | None = None,  # lanes that execute the store
    correct_specular_accumulation: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Functional StoreShadingOutput (ShadingHelpers.glsl:61-88).

    QUIRK preserved by default: in accumulation mode the reference blends
    the NEW diffuse into BOTH outputs using priorDiffuse (copy-paste bug,
    ShadingHelpers.glsl:72-73). correct_specular_accumulation=True
    accumulates specular properly instead (the RMSE gate's setting)."""
    if enable_accumulation:
        new_diffuse = diffuse_img + (diffuse - diffuse_img) * blend_factor
        if correct_specular_accumulation:
            new_specular = (specular_img
                            + (specular - specular_img) * blend_factor)
        else:
            new_specular = new_diffuse  # [sic] mix(priorDiffuse, diffuse, t)
    elif not is_first_pass:
        new_diffuse = diffuse_img + diffuse
        new_specular = specular_img + specular
    else:
        new_diffuse = diffuse
        new_specular = specular
    if write_mask is not None:
        m = write_mask[..., None]
        new_diffuse = torch.where(m, new_diffuse, diffuse_img)
        new_specular = torch.where(m, new_specular, specular_img)
    return new_diffuse, new_specular
