"""The ReSTIR GI pass chain, port of raytracer2_tpu/render/gi_passes.py:
BRDF rays -> secondary shading -> temporal -> spatial -> final shading.

Whole-image ports of the GI raygen shaders (SURVEY.md §3.4):
- brdf_rays.rgen:19-194 (one bounce ray per pixel -> packed SecondaryGBuffer)
- shade_secondary_surfaces.rgen:26-157 (1-sample ReSTIR DI on the bounce hit,
  or the single-bounce fallback with DI off -> initial GI reservoir)
- temporal_resampling.rgen:13-48 / spatial_resampling.rgen:13-39 (wrappers
  around restir/gi_resampling.py)
- gi_final_shading.rgen:43-101 (optional final visibility, split BRDF, MIS)

The passes launch on the full [H, W] grid, or under a checkerboard field
(1 or 2) on its active half of the pixels, with [H, W//2] reservoirs,
secondary G-buffer and lighting images (row sharding is not ported).
Launches above _BAND_THRESHOLD lanes run the per-pixel passes (BRDF rays,
secondary shading, final shading) in row bands, which bounds their
temporaries:
every RNG stream is seeded by pixel coordinates, so banding changes no
value (the BRDF rays' band-local bounce sort changes no hit, the exact
cull being exact).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.lights.polymorphic import DISTANT_LIGHT_DISTANCE
from raytracer2_tpu_torch.params import (
    BACKGROUND_DEPTH, K_SECONDARY_IS_DELTA_SURFACE,
    K_SECONDARY_IS_ENVIRONMENT_MAP, K_SECONDARY_IS_SPECULAR_RAY, GConst)
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.app_bridge import Tracers
from raytracer2_tpu_torch.render.banding import banded
from raytracer2_tpu_torch.render.shading import (
    shade_surface_with_light_sample, store_shading_output)
from raytracer2_tpu_torch.render.surface import (
    Surface, evaluate_brdf, get_surface_brdf_sample,
    get_surface_diffuse_probability)
from raytracer2_tpu_torch.restir import gi_resampling
from raytracer2_tpu_torch.restir.bridge import Bridge
from raytracer2_tpu_torch.restir.gi_reservoir import (
    GIReservoir, empty_gi_reservoir, is_valid as gi_is_valid,
    make_gi_reservoir, where_gi)
from raytracer2_tpu_torch.restir.initial_sampling import (
    LightSamplingContext, init_sample_parameters, sample_lights_for_surface)
from raytracer2_tpu_torch.scene.scene import (
    Scene, get_environment_radiance, get_geometry_from_hit)
from raytracer2_tpu_torch.utils import brdf as brdfm
from raytracer2_tpu_torch.utils import packing as pk
from raytracer2_tpu_torch.utils import rng as rtrng

K_MAX_INDIRECT_RADIANCE = 100.0  # c_MaxIndirectRadiance (shade_secondary:24)
K_MIS_ROUGHNESS = 0.3  # (gi_final_shading.rgen:16)
K_MAX_BRDF_VALUE = 1e4  # (gi_final_shading.rgen:15)

# launches above this lane count run the per-pixel passes in row bands
# (tests shrink it to cover the banded path at CPU sizes)
_BAND_THRESHOLD = 1 << 22


class SecondaryGBuffer(NamedTuple):
    """SecondaryGBufferData SoA, packed-field parity
    (ShaderParameters.glsl:49-60). [H, W] planes; u32 as int64."""

    world_pos: torch.Tensor  # [H, W, 3] f32
    normal: torch.Tensor  # [H, W] u32 oct
    throughput: torch.Tensor  # [H, W, 2] u32 (f16 rg / b + flags<<16)
    diffuse_albedo: torch.Tensor  # [H, W] u32 R11G11B10
    specular_and_roughness: torch.Tensor  # [H, W] u32 RGBA8-gamma
    emission: torch.Tensor  # [H, W, 3] f32
    pdf: torch.Tensor  # [H, W] f32


def empty_secondary_gbuffer(height: int, width: int, *, device
                            ) -> SecondaryGBuffer:
    def zeros(extra=(), dtype=torch.float32):
        return torch.zeros((height, width) + extra, dtype=dtype,
                           device=device)

    return SecondaryGBuffer(
        world_pos=zeros((3,)), normal=zeros(dtype=torch.int64),
        throughput=zeros((2,), torch.int64),
        diffuse_albedo=zeros(dtype=torch.int64),
        specular_and_roughness=zeros(dtype=torch.int64),
        emission=zeros((3,)), pdf=zeros())


def _flat(x, n: int):
    """[h, w, ...] tensors (or a named tuple of them) -> [n, ...]."""
    if isinstance(x, tuple):
        return type(x)(*(_flat(f, n) for f in x))
    return x.reshape((n,) + x.shape[2:])


def _primary(bridge: Bridge, width: int, height: int, field: int,
             primary_surface, device
             ) -> tuple[torch.Tensor, torch.Tensor, Surface]:
    """The launch grid's pixels and primary surface: [H, W], or the
    active field's [H, W//2]."""
    px, py = raysmod.active_pixel_grid(width, height, field, device=device)
    if primary_surface is None:
        primary_surface = bridge.get_gbuffer_surface(px, py, False)
    return px, py, primary_surface


# ---------------------------------------------------------------------------
# BRDF rays
# ---------------------------------------------------------------------------

def brdf_rays_pass(
    scene: Scene,
    g_const: GConst,
    tracers: Tracers,
    bridge: Bridge,
    diffuse_img: torch.Tensor,
    specular_img: torch.Tensor,
    width: int,
    height: int,
    field: int = 0,
    primary_surface: Surface | None = None,
) -> tuple[SecondaryGBuffer, torch.Tensor, torch.Tensor]:
    """brdf_rays.rgen:19-194. Returns (secondary G-buffer, diffuse,
    specular), planes of the launch grid: [H, W], or [H, W//2] under a
    checkerboard field (brdf_rays.rgen:21), whose half diffuse_img and
    specular_img then are too. primary_surface: the launch grid's surface
    (surface_from_gbuffer_grid), computed once per frame by render_frame;
    None reads it through the bridge."""
    px, py, surface = _primary(bridge, width, height, field,
                               primary_surface, diffuse_img.device)

    def body(px, py, surface, dif, spec):
        return _brdf_rays_body(scene, g_const, tracers, px, py, surface, dif,
                               spec)

    return banded(body, height, px.shape[1], _BAND_THRESHOLD, px, py,
                  surface, diffuse_img, specular_img)


def _brdf_rays_body(scene, g_const, tracers, px, py, surface, diffuse_img,
                    specular_img):
    h, w = px.shape
    n = h * w
    dev = px.device
    surface = _flat(surface, n)
    valid = surface.valid

    # RAB_InitRandomSampler(launchID, 5) (brdf_rays.rgen:28)
    rng = rtrng.init_random_sampler(px.reshape(-1), py.reshape(-1),
                                    g_const.frame + 5 * 13)

    tangent, bitangent = brdfm.construct_onb(surface.normal)
    cam = raysmod.view_tensor(g_const.view.camera_direction_or_position,
                              dev)[:3]
    depth_scale = torch.clamp_min(0.1 * torch.linalg.vector_norm(
        surface.world_pos - cam, dim=-1), 1.0)
    t_min = 0.001 * depth_scale

    # only valid lanes consume RNG (the shader early-returns, :25-26)
    rand2, adv = rtrng.sample_uniform_n(rng, 2)
    rng = rtrng.advance_where(rng, adv, valid)

    v = brdfm.normalize(cam - surface.world_pos)
    is_delta = surface.roughness == 0.0

    # specular lobe (brdf_rays.rgen:51-65): the tangent-frame order here is
    # (tangent, bitangent, normal), unlike the bridge helpers
    ve = torch.stack([brdfm.dot3(v, tangent), brdfm.dot3(v, bitangent),
                      brdfm.dot3(v, surface.normal)], dim=-1)
    he = brdfm.importance_sample_ggx_vndf(rand2, surface.roughness, ve)
    h_vec = brdfm.normalize(he[..., 0:1] * tangent + he[..., 1:2] * bitangent
                            + he[..., 2:3] * surface.normal)
    h_vec = torch.where(is_delta[..., None], surface.normal, h_vec)
    specular_dir = brdfm.reflect(-v, h_vec)
    hov = brdfm.saturate(brdfm.dot3(h_vec, v))
    nov = brdfm.saturate(brdfm.dot3(surface.normal, v))
    f = brdfm.schlick_fresnel(surface.specular_f0, hov)
    g1 = torch.where(is_delta, 1.0, torch.where(
        nov > 0.0, brdfm.g1_smith(surface.roughness, nov), 0.0))
    specular_brdf_over_pdf = f * g1[..., None]

    # diffuse lobe (:67-74)
    local_dir, _ = brdfm.sample_cos_hemisphere(rand2)
    diffuse_dir = (tangent * local_dir[..., 0:1]
                   + bitangent * local_dir[..., 1:2]
                   + surface.normal * local_dir[..., 2:3])

    spec_pdf = brdfm.saturate(
        brdfm.luminance(specular_brdf_over_pdf)
        / torch.clamp_min(brdfm.luminance(
            specular_brdf_over_pdf + surface.diffuse_albedo), 1e-30))

    r_spec, adv = rtrng.sample_uniform(rng)
    rng = rtrng.advance_where(rng, adv, valid)
    is_specular_ray = r_spec < spec_pdf

    direction = torch.where(is_specular_ray[..., None], specular_dir,
                            diffuse_dir)
    brdf_over_pdf = torch.where(
        is_specular_ray[..., None],
        specular_brdf_over_pdf / torch.clamp_min(spec_pdf, 1e-30)[..., None],
        (1.0 / torch.clamp_min(1.0 - spec_pdf, 1e-30))[..., None])

    specular_lobe_pdf = brdfm.importance_sample_ggx_vndf_pdf(
        surface.roughness, surface.normal, v, direction)
    diffuse_lobe_pdf = brdfm.saturate(
        brdfm.dot3(direction, surface.normal)) / brdfm.PI
    overall_pdf = torch.where(
        is_delta, diffuse_lobe_pdf,
        diffuse_lobe_pdf + (specular_lobe_pdf - diffuse_lobe_pdf) * spec_pdf)

    # geo-normal backface kill (:99-103)
    backface = brdfm.dot3(surface.geo_normal, direction) <= 0.0
    brdf_over_pdf = torch.where(backface[..., None], 0.0, brdf_over_pdf)
    t_max = torch.where(backface | ~valid, 0.0, BACKGROUND_DEPTH)

    hit = tracers.closest_hit(surface.world_pos, direction, t_min, t_max)
    missed = hit.missed
    geom = get_geometry_from_hit(
        scene, hit.geometry_index, hit.primitive_id,
        torch.stack([hit.u, hit.v], dim=-1),
        textures_enabled=bool(g_const.textures),
        triangle_index=hit.triangle_index)

    # (brdf_rays.rgen:121-124)
    include_emissive = (is_specular_ray & is_delta) | (
        g_const.enable_restir_di == 0)
    hit_pos = surface.world_pos + direction * hit.t[..., None]
    env_radiance = get_environment_radiance(scene, direction,
                                            g_const.environment)
    radiance = torch.where(
        include_emissive[..., None],
        torch.where(missed[..., None], env_radiance, geom.emission), 0.0)

    sec_normal = torch.where(
        (brdfm.dot3(geom.normal, direction) < 0.0)[..., None],
        geom.normal, -geom.normal)
    m3 = missed[..., None]
    sec_pos = torch.where(
        m3, surface.world_pos + direction * DISTANT_LIGHT_DISTANCE, hit_pos)
    sec_normal = torch.where(m3, -direction, sec_normal)
    sec_albedo = torch.where(m3, 0.0, geom.diffuse_albedo)
    sec_f0 = torch.where(m3, 0.0, geom.specular_f0)
    sec_rough = torch.where(missed, 0.0, geom.roughness)

    flags = (torch.where(is_specular_ray, K_SECONDARY_IS_SPECULAR_RAY, 0)
             | torch.where(is_delta, K_SECONDARY_IS_DELTA_SURFACE, 0)
             | torch.where(missed, K_SECONDARY_IS_ENVIRONMENT_MAP, 0))

    stored_emission = radiance
    if g_const.enable_restir_gi:
        radiance = torch.zeros_like(radiance)

    # pack (brdf_rays.rgen:158-183); invalid lanes keep zeros
    tp = pk.pack_r16g16b16a16_float(torch.cat(
        [brdf_over_pdf, torch.zeros((n, 1), device=dev)], dim=-1))
    tp = torch.stack([tp[..., 0], tp[..., 1] | (flags << 16)], dim=-1)

    def img(x):
        mask = valid.reshape((n,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x, torch.zeros_like(x)).reshape(
            (h, w) + x.shape[1:])

    if g_const.enable_brdf_indirect:
        secondary = SecondaryGBuffer(
            world_pos=img(sec_pos),
            normal=img(pk.ndir_to_oct_unorm32(sec_normal)),
            throughput=img(tp),
            diffuse_albedo=img(pk.pack_r11g11b10_ufloat(sec_albedo)),
            specular_and_roughness=img(pk.pack_rgba8_gamma_ufloat(
                torch.cat([sec_f0, sec_rough[..., None]], dim=-1))),
            emission=img(stored_emission),
            pdf=img(overall_pdf))
    else:
        secondary = empty_secondary_gbuffer(h, w, device=dev)

    # immediate output for emissive/env radiance (:186-194)
    s3 = is_specular_ray[..., None]
    out_d = torch.where(s3, 0.0, radiance * brdf_over_pdf)
    out_s = brdfm.demodulate_specular(
        surface.specular_f0, torch.where(s3, radiance * brdf_over_pdf, 0.0))
    write = valid & ((radiance > 0.0).any(dim=-1)
                     | (g_const.enable_brdf_additive_blend == 0))
    diffuse_img, specular_img = store_shading_output(
        diffuse_img, specular_img, out_d.reshape(h, w, 3),
        out_s.reshape(h, w, 3), is_first_pass=False,
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation),
        write_mask=write.reshape(h, w))
    return secondary, diffuse_img, specular_img


# ---------------------------------------------------------------------------
# Secondary surfaces
# ---------------------------------------------------------------------------

def _unpack_secondary_surface(secondary: SecondaryGBuffer, primary: Surface
                              ) -> tuple[Surface, torch.Tensor, torch.Tensor]:
    """shade_secondary_surfaces.rgen:39-61. Returns (surface, throughput,
    flags)."""
    throughput = pk.unpack_r16g16b16a16_float(secondary.throughput)[..., :3]
    flags = pk.as_u32(secondary.throughput[..., 1]) >> 16
    normal = pk.oct_unorm32_to_ndir(secondary.normal)
    albedo = pk.unpack_r11g11b10_ufloat(secondary.diffuse_albedo)
    sr = pk.unpack_rgba8_gamma_ufloat(secondary.specular_and_roughness)
    view_dir = brdfm.normalize(primary.world_pos - secondary.world_pos)
    surface = Surface(
        world_pos=secondary.world_pos,
        view_dir=view_dir,
        view_depth=torch.ones(secondary.pdf.shape,
                              device=secondary.pdf.device),  # (:53)
        normal=normal,
        geo_normal=normal,
        diffuse_albedo=albedo,
        specular_f0=sr[..., :3],
        roughness=sr[..., 3],
        diffuse_probability=get_surface_diffuse_probability(
            albedo, sr[..., :3], view_dir, normal))
    return surface, throughput, flags


def shade_secondary_surfaces_pass(
    scene: Scene,
    g_const: GConst,
    tracers: Tracers,
    bridge: Bridge,
    light_ctx: LightSamplingContext,
    secondary: SecondaryGBuffer,
    diffuse_img: torch.Tensor,
    specular_img: torch.Tensor,
    width: int,
    height: int,
    field: int = 0,
    primary_surface: Surface | None = None,
) -> tuple[GIReservoir, SecondaryGBuffer, torch.Tensor, torch.Tensor]:
    """shade_secondary_surfaces.rgen:26-157. Returns (initial GI
    reservoirs, updated secondary G-buffer, diffuse, specular), planes of
    the launch grid (brdf_rays_pass)."""
    px, py, primary = _primary(bridge, width, height, field,
                               primary_surface, diffuse_img.device)

    def body(px, py, primary, secondary, dif, spec):
        return _shade_secondary_body(scene, g_const, tracers, bridge,
                                     light_ctx, px, py, primary, secondary,
                                     dif, spec)

    return banded(body, height, px.shape[1], _BAND_THRESHOLD, px, py,
                  primary, secondary, diffuse_img, specular_img)


def _shade_secondary_body(scene, g_const, tracers, bridge, light_ctx, px, py,
                          primary, secondary, diffuse_img, specular_img):
    h, w = px.shape
    dev = px.device
    rng = rtrng.init_random_sampler(px, py, g_const.frame + 6 * 13)
    tile_rng = rtrng.init_random_sampler(px // 16, py // 16,
                                         g_const.frame + 13)
    sec_surface, throughput, flags = _unpack_secondary_surface(secondary,
                                                               primary)

    is_valid_secondary = (throughput != 0.0).any(dim=-1)
    is_specular_ray = (flags & K_SECONDARY_IS_SPECULAR_RAY) != 0
    is_delta = (flags & K_SECONDARY_IS_DELTA_SURFACE) != 0
    is_env = (flags & K_SECONDARY_IS_ENVIRONMENT_MAP) != 0
    take = is_valid_secondary & ~is_env

    radiance = secondary.emission
    if g_const.enable_restir_di:
        # 1-sample BRDF ReSTIR DI on the secondary surface (:64-117). The
        # only candidate is the BRDF sample, whose own ray found the light
        # (or escaped to the environment): the sample is visible by
        # construction, so the shading takes it as visible instead of
        # re-tracing the same ray (the reference's :109); lanes without a
        # light have solid_angle_pdf == 0 and shade to zero either way
        sample_params = init_sample_parameters(0, 0, 0, 1, 0.0, 0.001)
        reservoir, light_sample, rng, tile_rng = sample_lights_for_surface(
            rng, tile_rng, sec_surface, sample_params, light_ctx, bridge)
        _, ind_diffuse, ind_specular, _ = shade_surface_with_light_sample(
            reservoir, sec_surface, light_sample,
            g_const.restir_di.shading_params,
            g_const.restir_di.temporal_resampling_params, bridge,
            enable_visibility_reuse=False,
            known_visibility=torch.ones((h, w), dtype=torch.bool,
                                        device=dev))
        radiance = radiance + torch.where(
            take[..., None],
            ind_diffuse * sec_surface.diffuse_albedo + ind_specular, 0.0)
        # firefly clamp (:113-116)
        lum = brdfm.luminance(radiance)
        scale = torch.where(lum > K_MAX_INDIRECT_RADIANCE,
                            K_MAX_INDIRECT_RADIANCE
                            / torch.clamp_min(lum, 1e-30), 1.0)
        radiance = radiance * torch.where(take, scale, 1.0)[..., None]
    else:
        # fallback single bounce (:119-128)
        new_dir, _, _ = get_surface_brdf_sample(sec_surface, rng)
        o = sec_surface.world_pos.reshape(-1, 3)
        d = new_dir.reshape(-1, 3)
        hit = tracers.closest_hit(o, d, 0.001, 1000.0)
        geom = get_geometry_from_hit(
            scene, hit.geometry_index, hit.primitive_id,
            torch.stack([hit.u, hit.v], dim=-1),
            textures_enabled=bool(g_const.textures),
            triangle_index=hit.triangle_index)
        emission = torch.where(
            hit.missed[..., None],
            get_environment_radiance(scene, d, g_const.environment),
            geom.emission).reshape(h, w, 3)
        radiance = radiance + torch.where(
            take[..., None], emission * sec_surface.diffuse_albedo, 0.0)

    # initial GI reservoir (:130-142)
    output_shading_result = is_specular_ray & is_delta
    reservoir_gi = where_gi(
        is_valid_secondary & ~output_shading_result,
        make_gi_reservoir(sec_surface.world_pos, sec_surface.normal,
                          radiance, secondary.pdf),
        empty_gi_reservoir((h, w), device=dev))

    # save radiance for final-pass MIS (:144-146)
    out3 = output_shading_result[..., None]
    secondary = secondary._replace(emission=torch.where(out3, 0.0, radiance))

    # delta-specular shortcut output (:148-156)
    s3 = is_specular_ray[..., None]
    out_d = torch.where(s3, 0.0, radiance)
    out_s = brdfm.demodulate_specular(primary.specular_f0,
                                      torch.where(s3, radiance, 0.0))
    diffuse_img, specular_img = store_shading_output(
        diffuse_img, specular_img, out_d, out_s, is_first_pass=False,
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation),
        write_mask=output_shading_result)
    return reservoir_gi, secondary, diffuse_img, specular_img


# ---------------------------------------------------------------------------
# Temporal and spatial resampling
# ---------------------------------------------------------------------------

def gi_temporal_pass(
    g_const: GConst,
    bridge: Bridge,
    input_reservoirs: GIReservoir,  # launch grid: current initial ones
    prev_reservoirs: GIReservoir,  # launch grid: previous frame source
    motion: torch.Tensor,  # [H, W, 3], or the active field's [H, W//2, 3]
    width: int,
    height: int,
    field: int = 0,
    primary_surface: Surface | None = None,
) -> GIReservoir:
    """temporal_resampling.rgen:13-48, on the launch grid (brdf_rays_pass);
    under a checkerboard field the neighbour math stays in full-resolution
    pixels and the library maps them to reservoir positions
    (temporal_resampling.rgen:16)."""
    px, py, primary = _primary(bridge, width, height, field,
                               primary_surface, motion.device)
    h, w = px.shape
    n = h * w
    rng = rtrng.init_random_sampler(px, py, g_const.frame + 7 * 13)
    motion_px = raysmod.convert_motion_vector_to_pixel_space(
        g_const.view, g_const.prev_view, px, py, motion)

    tp = g_const.restir_gi.temporal_resampling_params
    # jittered age threshold to avoid mass reservoir death (:39-41)
    r, rng = rtrng.sample_uniform(rng)
    max_age = (tp.max_reservoir_age * (0.5 + r * 0.5)).to(torch.int64)

    spec = gi_resampling.GITemporalSpec(
        max_history_length=tp.max_history_length,
        bias_correction_mode=tp.temporal_bias_correction_mode,
        depth_threshold=tp.depth_threshold,
        normal_threshold=tp.normal_threshold,
        enable_permutation_sampling=bool(tp.enable_permutation_sampling),
        enable_fallback_sampling=bool(tp.enable_fallback_sampling),
        active_checkerboard_field=(
            g_const.runtime_params.active_checkerboard_field))
    out, _ = gi_resampling.gi_temporal_resampling(
        px.reshape(-1), py.reshape(-1), _flat(primary, n),
        _flat(input_reservoirs, n), _flat(rng, n), spec,
        motion_px.reshape(-1, 3), int(tp.uniform_random_number),
        max_age.reshape(-1), prev_reservoirs, bridge)
    out = GIReservoir(*(a.reshape((h, w) + a.shape[1:]) for a in out))
    if tp.enable_boiling_filter:
        # at the end of the temporal pass (GIResamplingFunctions.hlsli:
        # 885-894)
        out = gi_resampling.gi_boiling_filter(out, tp.boiling_filter_strength)
    return where_gi(primary.valid, out, input_reservoirs)


def gi_spatial_pass(
    g_const: GConst,
    bridge: Bridge,
    input_reservoirs: GIReservoir,  # launch grid
    width: int,
    height: int,
    field: int = 0,
    primary_surface: Surface | None = None,
) -> GIReservoir:
    """spatial_resampling.rgen:13-39, on the launch grid
    (brdf_rays_pass)."""
    dev = input_reservoirs.weight_sum.device
    px, py, primary = _primary(bridge, width, height, field,
                               primary_surface, dev)
    h, w = px.shape
    n = h * w
    rng = rtrng.init_random_sampler(px, py, g_const.frame + 8 * 13)
    sp = g_const.restir_gi.spatial_resampling_params
    spec = gi_resampling.GISpatialSpec(
        depth_threshold=sp.spatial_depth_threshold,
        normal_threshold=sp.spatial_normal_threshold,
        num_samples=sp.num_spatial_samples,
        sampling_radius=sp.spatial_sampling_radius,
        bias_correction_mode=sp.spatial_bias_correction_mode,
        active_checkerboard_field=(
            g_const.runtime_params.active_checkerboard_field),
        neighbor_offset_mask=g_const.runtime_params.neighbor_offset_mask)
    out, _ = gi_resampling.gi_spatial_resampling(
        px.reshape(-1), py.reshape(-1), _flat(primary, n),
        _flat(input_reservoirs, n), _flat(rng, n), spec, input_reservoirs,
        bridge)
    out = GIReservoir(*(a.reshape((h, w) + a.shape[1:]) for a in out))
    return where_gi(primary.valid, out, input_reservoirs)


# ---------------------------------------------------------------------------
# Final shading
# ---------------------------------------------------------------------------

def _get_mis_weight(rough_brdf, true_brdf, diffuse_albedo) -> torch.Tensor:
    """GetMISWeight (gi_final_shading.rgen:18-28)."""
    combined_rough = (rough_brdf.demodulated_diffuse[..., None]
                      * diffuse_albedo + rough_brdf.specular)
    combined_true = (true_brdf.demodulated_diffuse[..., None]
                     * diffuse_albedo + true_brdf.specular)
    combined_rough = torch.clamp(combined_rough, 1e-4, K_MAX_BRDF_VALUE)
    combined_true = torch.clamp(combined_true, 0.0, K_MAX_BRDF_VALUE)
    w = brdfm.saturate(
        brdfm.luminance(combined_true)
        / torch.clamp_min(brdfm.luminance(combined_true + combined_rough),
                          1e-30))
    return w * w * w


def gi_final_shading_pass(
    g_const: GConst,
    bridge: Bridge,
    reservoirs: GIReservoir,  # launch grid: final reservoirs
    secondary: SecondaryGBuffer,
    diffuse_img: torch.Tensor,
    specular_img: torch.Tensor,
    width: int,
    height: int,
    field: int = 0,
    primary_surface: Surface | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """gi_final_shading.rgen:43-101: optional final visibility, the split
    BRDF and MIS against the initial sample, on the launch grid
    (brdf_rays_pass)."""
    px, _, primary = _primary(bridge, width, height, field,
                              primary_surface, diffuse_img.device)

    def body(primary, res, sec, dif, spec):
        return _gi_final_shading_body(g_const, bridge, res, sec, dif, spec,
                                      primary)

    return banded(body, height, px.shape[1], _BAND_THRESHOLD, primary,
                  reservoirs, secondary, diffuse_img, specular_img)


def _gi_final_shading_body(g_const, bridge, reservoirs, secondary,
                           diffuse_img, specular_img, primary):
    valid = gi_is_valid(reservoirs)
    radiance = reservoirs.radiance * reservoirs.weight_sum[..., None]
    fsp = g_const.restir_gi.final_shading_params

    if fsp.enable_final_visibility:
        visible = bridge.get_conservative_visibility(primary,
                                                     reservoirs.position)
        radiance = radiance * torch.where(visible, 1.0, 0.0)[..., None]

    brdf = evaluate_brdf(primary, reservoirs.position)

    if fsp.enable_final_mis:
        # initial-sample reservoir from the secondary G-buffer (:30-41)
        tp4 = pk.unpack_r16g16b16a16_float(secondary.throughput)
        init_res = make_gi_reservoir(
            secondary.world_pos, pk.oct_unorm32_to_ndir(secondary.normal),
            secondary.emission * tp4[..., :3], secondary.pdf)

        brdf0 = evaluate_brdf(primary, init_res.position)
        rough_surface = primary._replace(
            roughness=torch.clamp_min(primary.roughness, K_MIS_ROUGHNESS))
        rough_brdf = evaluate_brdf(rough_surface, reservoirs.position)
        rough_brdf0 = evaluate_brdf(rough_surface, init_res.position)

        final_w = 1.0 - _get_mis_weight(rough_brdf, brdf,
                                        primary.diffuse_albedo)
        init_w = _get_mis_weight(rough_brdf0, brdf0, primary.diffuse_albedo)
        init_radiance = init_res.radiance * init_res.weight_sum[..., None]

        diffuse = (brdf.demodulated_diffuse[..., None] * radiance
                   * final_w[..., None]
                   + brdf0.demodulated_diffuse[..., None] * init_radiance
                   * init_w[..., None])
        specular = (brdf.specular * radiance * final_w[..., None]
                    + brdf0.specular * init_radiance * init_w[..., None])
    else:
        diffuse = brdf.demodulated_diffuse[..., None] * radiance
        specular = brdf.specular * radiance

    specular = brdfm.demodulate_specular(primary.specular_f0, specular)
    diffuse = torch.where(valid[..., None], diffuse, 0.0)
    specular = torch.where(valid[..., None], specular, 0.0)
    return store_shading_output(
        diffuse_img, specular_img, diffuse, specular,
        is_first_pass=(g_const.enable_restir_di == 0),
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation))
