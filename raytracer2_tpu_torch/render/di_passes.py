"""ReSTIR DI fused sampling + shading pass, port of
raytracer2_tpu/render/di_passes.py (lighting_passes/di_fused_resampling.rgen:
16-93): initial candidate sampling through RTXDI_SampleLightsForSurface,
the optional initial-visibility kill, then shading with the final
visibility ray.

Mode 0 only (GConst.enable_di_resampling = 0): the reference's
spatio-temporal call is commented out (di_fused_resampling.rgen:69-70), so
the reservoir shipped to shading is the initial-candidate one. The
library's temporal/spatial stages (modes 1-3) and the boiling filter are
off this path (ROADMAP queue A) and raise.
"""

from __future__ import annotations

import torch

from raytracer2_tpu_torch.params import GConst
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.banding import banded
from raytracer2_tpu_torch.render.shading import (
    shade_surface_with_light_sample, store_shading_output)
from raytracer2_tpu_torch.render.surface import Surface
from raytracer2_tpu_torch.restir import di_reservoir as dires
from raytracer2_tpu_torch.restir.bridge import Bridge
from raytracer2_tpu_torch.restir.initial_sampling import (
    LightSamplingContext, init_sample_parameters, sample_lights_for_surface)
from raytracer2_tpu_torch.utils import brdf as brdfm
from raytracer2_tpu_torch.utils import rng as rtrng

# launches above this lane count run the pass body in row bands, which
# bounds its temporaries (every RNG stream is seeded by pixel coordinates
# and mode 0 reads no neighbour, so banding changes no value; tests shrink
# it to cover the banded path at CPU sizes)
_BAND_THRESHOLD = 1 << 22


def di_fused_resampling_pass(
    g_const: GConst,
    bridge: Bridge,
    light_ctx: LightSamplingContext,
    diffuse_img: torch.Tensor,
    specular_img: torch.Tensor,
    width: int,
    height: int,
    field: int = 0,
    primary_surface: Surface | None = None,
) -> tuple[dires.DIReservoir, torch.Tensor, torch.Tensor]:
    """Returns (reservoirs for the shading-input slot, diffuse, specular),
    [H, W] planes, or [H, W//2] under a checkerboard field (1 or 2), where
    only the active half of the pixels is sampled and shaded
    (di_fused_resampling.rgen:19); diffuse_img and specular_img are then
    that half too. primary_surface: the launch grid's surface
    (surface_from_gbuffer_grid), computed once per frame by render_frame;
    None reads it through the bridge."""
    if g_const.enable_di_resampling:
        raise NotImplementedError(
            "DI spatio-temporal resampling (enable_di_resampling != 0) is "
            "not ported (ROADMAP queue A)")
    if g_const.restir_di.temporal_resampling_params.enable_boiling_filter:
        raise NotImplementedError("the DI boiling filter is not ported")
    dev = diffuse_img.device
    px, py = raysmod.active_pixel_grid(width, height, field, device=dev)
    surface = (primary_surface if primary_surface is not None
               else bridge.get_gbuffer_surface(px, py, False))

    def body(px, py, surface, dif, spec):
        return _di_fused_body(g_const, bridge, light_ctx, px, py, surface,
                              dif, spec)

    return banded(body, height, px.shape[1], _BAND_THRESHOLD, px, py,
                  surface, diffuse_img, specular_img)


def _di_fused_body(g_const: GConst, bridge: Bridge,
                   light_ctx: LightSamplingContext, px, py, surface: Surface,
                   diffuse_img, specular_img):
    seed = (g_const.frame + 13) & 0xFFFFFFFF
    rng = rtrng.init_random_sampler(px, py, seed)
    tile_rng = rtrng.init_random_sampler(px // 16, py // 16, seed)

    isp = g_const.restir_di.initial_sampling_params
    sample_params = init_sample_parameters(
        isp.num_primary_local_light_samples,
        isp.num_primary_infinite_light_samples,
        isp.num_primary_environment_samples,
        isp.num_primary_brdf_samples, isp.brdf_cutoff, 0.001)

    reservoir, light_sample, rng, tile_rng = sample_lights_for_surface(
        rng, tile_rng, surface, sample_params, light_ctx, bridge)

    vis_known = None
    if isp.enable_initial_visibility:
        # initial visibility kill (di_fused_resampling.rgen:40-46); nothing
        # resamples before shading, so its rays are the shading rays too
        visible = bridge.get_conservative_visibility(surface,
                                                     light_sample.position)
        reservoir = dires.store_visibility(
            reservoir, torch.zeros_like(light_sample.position), True,
            active=dires.is_valid(reservoir) & ~visible)
        vis_known = visible

    valid = dires.is_valid(reservoir)
    reservoir_shaded, diffuse, specular, _ = shade_surface_with_light_sample(
        reservoir, surface, light_sample, g_const.restir_di.shading_params,
        g_const.restir_di.temporal_resampling_params, bridge,
        enable_visibility_reuse=True, known_visibility=vis_known)
    diffuse = torch.where(valid[..., None], diffuse, 0.0)
    specular = torch.where(
        valid[..., None],
        brdfm.demodulate_specular(surface.specular_f0, specular), 0.0)

    diffuse_img, specular_img = store_shading_output(
        diffuse_img, specular_img, diffuse, specular,
        is_first_pass=(g_const.enable_restir_di == 1),
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation))
    return reservoir_shaded, diffuse_img, specular_img
