"""ReSTIR DI fused sampling + shading pass, port of
raytracer2_tpu/render/di_passes.py (lighting_passes/di_fused_resampling.rgen:
16-93): initial candidate sampling through RTXDI_SampleLightsForSurface,
the optional initial-visibility kill, the library's temporal and spatial
resampling and the DI boiling filter where GConst asks for them, then
shading with the final visibility ray.

GConst.enable_di_resampling 0 keeps the reference's behaviour: its
spatio-temporal call is commented out (di_fused_resampling.rgen:69-70), so
the reservoir shipped to shading is the initial-candidate one. 1, 2 and 3
run the temporal stage, the spatial stage or both
(restir/di_resampling.py, DIResamplingFunctions.hlsli:170/504), each
inside a utils/profiler.span: pass.di.temporal (the temporal stage and
the boiling filter after it) and pass.di.spatial.
"""

from __future__ import annotations

import contextlib
import math

import torch

from raytracer2_tpu_torch.params import GConst
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.banding import banded
from raytracer2_tpu_torch.render.shading import (
    shade_surface_with_light_sample, store_shading_output)
from raytracer2_tpu_torch.render.surface import Surface
from raytracer2_tpu_torch.restir import di_reservoir as dires
from raytracer2_tpu_torch.restir.bridge import Bridge
from raytracer2_tpu_torch.restir.di_resampling import (
    DISpatialSpec, DITemporalSpec, di_boiling_filter, di_spatial_resampling,
    di_temporal_resampling)
from raytracer2_tpu_torch.restir.initial_sampling import (
    LightSamplingContext, init_sample_parameters, sample_lights_for_surface)
from raytracer2_tpu_torch.utils import brdf as brdfm
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.profiler import span

# launches above this lane count run the pass body in row bands, which
# bounds its temporaries (every RNG stream is seeded by pixel coordinates
# and mode 0 reads no neighbour, so banding changes no value; the
# resampling modes and the boiling filter read neighbours and never band;
# tests shrink it to cover the banded path at CPU sizes)
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
    motion: torch.Tensor | None = None,
    prev_di_reservoirs: dires.DIReservoir | None = None,
    row0: int = 0,
    halo_fn=None,
    halo_rows: int = 8,
) -> tuple[dires.DIReservoir, torch.Tensor, torch.Tensor]:
    """Returns (reservoirs for the shading-input slot, diffuse, specular),
    [H, W] planes, or [H, W//2] under a checkerboard field (1 or 2), where
    only the active half of the pixels is sampled and shaded
    (di_fused_resampling.rgen:19); diffuse_img and specular_img are then
    that half too. primary_surface: the launch grid's surface
    (surface_from_gbuffer_grid), computed once per frame by render_frame;
    None reads it through the bridge. The temporal stage (modes 1 and 3)
    runs when `motion` (the launch grid's [..., 3] screen-space motion)
    and `prev_di_reservoirs` (last frame's temporal-input slot) are
    given.

    Under row sharding (parallel/mesh.py) height is the tile's, row0 its
    first global row (pixel RNG stays global) and halo_fn(tree, r) pads a
    reservoir tile with r rows of each neighbour tile: the temporal stage
    reads the previous reservoirs through halo_rows of them, the spatial
    stage through min(ceil(radius) + 1, tile rows), and gathers beyond a
    halo clamp to it, as the JAX package's do. The port's row0 is always
    a Python int, where JAX's is traced under shard_map: a tile that is
    not the whole image (row0 != 0, or fewer rows than the viewport)
    stands for JAX's traced row0 in the guard below, while mode 0 bands a
    tile as an image of its height would (banding is bit-exact; JAX
    never bands a traced tile)."""
    dev = diffuse_img.device
    px, py = raysmod.active_pixel_grid(width, height, field, device=dev)
    py = py + row0
    surface = (primary_surface if primary_surface is not None
               else bridge.get_gbuffer_surface(px, py, False))
    mode = int(g_const.enable_di_resampling)
    if mode and halo_fn is None and (row0 != 0
                                     or height != bridge.viewport[1]):
        # a row tile's reservoir planes hold its own rows only: global
        # rows gathered from them would clamp to the wrong rows
        raise ValueError(
            "enable_di_resampling != 0 on a row tile needs halo_fn "
            "(parallel/mesh.py::make_sharded_render_fn(explicit_halo="
            "True)); a tile's reservoir planes cannot be gathered with "
            "global rows")
    boiling = bool(g_const.restir_di.temporal_resampling_params
                   .enable_boiling_filter)

    def body(px, py, surface, dif, spec):
        return _di_fused_body(g_const, bridge, light_ctx, px, py, surface,
                              dif, spec, mode=mode, field=field,
                              motion=motion,
                              prev_di_reservoirs=prev_di_reservoirs,
                              row0=row0, halo_fn=halo_fn,
                              halo_rows=halo_rows)

    threshold = (_BAND_THRESHOLD if mode == 0 and not boiling
                 else height * px.shape[1])
    return banded(body, height, px.shape[1], threshold, px, py, surface,
                  diffuse_img, specular_img)


def _di_fused_body(g_const: GConst, bridge: Bridge,
                   light_ctx: LightSamplingContext, px, py, surface: Surface,
                   diffuse_img, specular_img, mode: int = 0, field: int = 0,
                   motion=None, prev_di_reservoirs=None, row0: int = 0,
                   halo_fn=None, halo_rows: int = 8):
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
        # initial visibility kill (di_fused_resampling.rgen:40-46); where
        # nothing resamples before shading, its rays are the shading rays
        visible = bridge.get_conservative_visibility(surface,
                                                     light_sample.position)
        reservoir = dires.store_visibility(
            reservoir, torch.zeros_like(light_sample.position), True,
            active=dires.is_valid(reservoir) & ~visible)
        vis_known = visible

    trp = g_const.restir_di.temporal_resampling_params
    temporal = (mode in (1, 3) and prev_di_reservoirs is not None
                and motion is not None)
    with span("pass.di.temporal") if temporal else contextlib.nullcontext():
        if temporal:
            t_spec = DITemporalSpec(
                max_history_length=trp.max_history_length,
                bias_correction_mode=trp.temporal_bias_correction,
                depth_threshold=trp.temporal_depth_threshold,
                normal_threshold=trp.temporal_normal_threshold,
                enable_visibility_shortcut=bool(
                    trp.discard_invisible_samples),
                enable_permutation_sampling=bool(
                    trp.enable_permutation_sampling),
                active_checkerboard_field=field)
            # under sharding the previous reservoir tile, halo-padded
            prev_src, prev_base = prev_di_reservoirs, 0
            if halo_fn is not None:
                prev_src = halo_fn(prev_di_reservoirs, halo_rows)
                prev_base = row0 - halo_rows
            reservoir, rng = di_temporal_resampling(
                px, py, surface, reservoir, rng, t_spec, motion,
                trp.uniform_random_number, prev_src, bridge,
                row_base=prev_base)
            vis_known = None  # the selected sample may no longer be ours

        # the DI boiling filter (DIResamplingFunctions.hlsli:101-116) on the
        # temporal stage's reservoir image
        if trp.enable_boiling_filter:
            reservoir = di_boiling_filter(reservoir,
                                          trp.boiling_filter_strength)

    if mode in (2, 3):
        srp = g_const.restir_di.spatial_resampling_params
        s_spec = DISpatialSpec(
            num_samples=srp.num_spatial_samples,
            num_disocclusion_boost_samples=srp.num_disocclusion_boost_samples,
            target_history_length=trp.max_history_length,
            bias_correction_mode=srp.spatial_bias_correction,
            sampling_radius=srp.spatial_sampling_radius,
            depth_threshold=srp.spatial_depth_threshold,
            normal_threshold=srp.spatial_normal_threshold,
            discount_naive_samples=bool(srp.discount_naive_samples),
            active_checkerboard_field=field,
            neighbor_offset_mask=srp.neighbor_offset_mask)
        # the neighbours' source is this frame's reservoir image itself;
        # under sharding padded with up to a tile of halo rows (the DI
        # radius can exceed a small tile; gathers beyond the halo clamp,
        # as at the screen's edges, RtxdiApplicationBridge.glsl:252-265)
        with span("pass.di.spatial"):
            src, src_base = reservoir, 0
            if halo_fn is not None:
                r = min(math.ceil(float(srp.spatial_sampling_radius)) + 1,
                        reservoir.weight_sum.shape[0])
                src = halo_fn(reservoir, r)
                src_base = row0 - r
            reservoir, rng = di_spatial_resampling(
                px, py, surface, reservoir, rng, s_spec, src, bridge,
                row_base=src_base)
        vis_known = None

    if mode != 0:
        # the winner may carry a reused sample: shade the final
        # reservoir's own light sample, as the reference's resampling
        # functions return it (DIResamplingFunctions.hlsli:345-352)
        info = bridge.load_light_info(dires.light_index(reservoir), False)
        light_sample = bridge.sample_polymorphic_light(
            info, surface, dires.sample_uv(reservoir))

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
