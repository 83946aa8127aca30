"""DI initial candidate sampling: local, infinite, environment and BRDF
candidates, port of raytracer2_tpu/restir/initial_sampling.py
(rtxdi/InitialSamplingFunctions.hlsli with RISBuffer.hlsli), vectorized
over pixel lanes. The BRDF candidate's ray (RAB_TraceRayForLocalLight in
RTXDI_SampleBrdf, InitialSamplingFunctions.hlsli:507-591) is one batched
closest-hit trace per candidate through the bridge.

Local lights are drawn uniformly (local_light_sampling_mode 0), from the
presampled RIS tiles (mode 1) or from the surface's cell of the ReGIR
grid (mode 2, restir/regir.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracer2_tpu_torch.lights.polymorphic import (
    K_ENVIRONMENT, K_TRIANGLE, LightInfo, LightSample, gather_light)
from raytracer2_tpu_torch.params import (
    LightBufferParameters, RISBufferSegmentParameters,
    RTXDI_INVALID_LIGHT_INDEX)
from raytracer2_tpu_torch.render.surface import Surface
from raytracer2_tpu_torch.restir import regir as regir_mod
from raytracer2_tpu_torch.restir.bridge import Bridge
from raytracer2_tpu_torch.restir.di_reservoir import (
    DIReservoir, combine_reservoirs, empty_di_reservoir, finalize_resampling,
    stream_sample)
from raytracer2_tpu_torch.utils import brdf
from raytracer2_tpu_torch.utils import rng as rtrng

FLT_MAX = 3.402823466e38


class SampleParameters(NamedTuple):
    """RTXDI_SampleParameters (InitialSamplingFunctions.hlsli:29-73)."""

    num_local_light_samples: int
    num_infinite_light_samples: int
    num_environment_map_samples: int
    num_brdf_samples: int
    num_mis_samples: int
    local_light_mis_weight: float
    environment_map_mis_weight: float
    brdf_mis_weight: float
    brdf_cutoff: float
    brdf_ray_min_t: float


def init_sample_parameters(num_local, num_infinite, num_environment,
                           num_brdf, brdf_cutoff=0.0, brdf_ray_min_t=0.001
                           ) -> SampleParameters:
    """(InitialSamplingFunctions.hlsli:51-73)."""
    num_mis = max(num_local + num_environment + num_brdf, 1)
    return SampleParameters(
        num_local_light_samples=num_local,
        num_infinite_light_samples=num_infinite,
        num_environment_map_samples=num_environment,
        num_brdf_samples=num_brdf,
        num_mis_samples=num_local + num_environment + num_brdf,
        local_light_mis_weight=num_local / num_mis,
        environment_map_mis_weight=num_environment / num_mis,
        brdf_mis_weight=num_brdf / num_mis,
        brdf_cutoff=brdf_cutoff, brdf_ray_min_t=brdf_ray_min_t)


def brdf_max_distance_from_pdf(brdf_cutoff: float, pdf: torch.Tensor
                               ) -> torch.Tensor:
    """(InitialSamplingFunctions.hlsli:76-80)."""
    if brdf_cutoff <= 0.0:
        return torch.full_like(pdf, FLT_MAX)
    return torch.sqrt(torch.clamp_min((1.0 / brdf_cutoff - 1.0) * pdf, 0.0))


def _empty_light_sample(shape, device) -> LightSample:
    z3 = torch.zeros(shape + (3,), device=device)
    return LightSample(z3, z3, z3, torch.zeros(shape, device=device),
                       torch.zeros(shape, dtype=torch.int64, device=device))


def _select_sample(mask, a: LightSample, b: LightSample) -> LightSample:
    return LightSample(*(torch.where(mask[..., None] if x.dim() > mask.dim()
                                     else mask, x, y) for x, y in zip(a, b)))


def _uniform_index(rnd, region) -> torch.Tensor:
    return region.first_light_index + torch.clamp_max(
        (rnd * region.num_lights).to(torch.int64), region.num_lights - 1)


def _lane_light(ctx, index: int, shape, device) -> tuple[torch.Tensor,
                                                         LightInfo]:
    idx = torch.full(shape, index, dtype=torch.int64, device=device)
    return idx, gather_light(ctx.lights, idx)


def _as_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> the float32 values they hold."""
    b = bits & 0xFFFFFFFF
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(
        torch.int32).view(torch.float32)


def light_brdf_mis_weight(bridge: Bridge, surface: Surface,
                          light_sample: LightSample, light_selection_pdf,
                          light_mis_weight: float, is_environment_map: bool,
                          sample_params: SampleParameters) -> torch.Tensor:
    """(InitialSamplingFunctions.hlsli:85-115)."""
    sa_pdf = light_sample.solid_angle_pdf
    analytic = ((light_sample.light_type != K_TRIANGLE)
                & (light_sample.light_type != K_ENVIRONMENT))
    simple = (analytic | (sa_pdf <= 0) | ~torch.isfinite(sa_pdf)
              | (sample_params.brdf_mis_weight == 0))
    simple_weight = light_mis_weight * light_selection_pdf

    # RAB_GetLightDirDistance (bridge:527-542)
    to_light = light_sample.position - surface.world_pos
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    ldir_local = to_light / torch.clamp_min(dist, 1e-30)[..., None]
    env = light_sample.light_type == K_ENVIRONMENT
    ldir = torch.where(env[..., None], -light_sample.normal, ldir_local)
    dist = torch.where(env, 1000.0, dist)

    brdf_pdf = bridge.get_surface_brdf_pdf(surface, ldir)
    max_dist = brdf_max_distance_from_pdf(sample_params.brdf_cutoff,
                                          brdf_pdf)
    if not is_environment_map:
        brdf_pdf = torch.where(dist > max_dist, 0.0, brdf_pdf)
    blended = (light_mis_weight * (light_selection_pdf * sa_pdf)
               + sample_params.brdf_mis_weight * brdf_pdf)
    full_weight = blended / torch.clamp_min(sa_pdf, 1e-30)
    return torch.where(simple, simple_weight, full_weight)


# ---------------------------------------------------------------------------
# RIS tiles (RISBuffer.hlsli)
# ---------------------------------------------------------------------------

class RISTileInfo(NamedTuple):
    """(RISBuffer.hlsli:14-18)."""

    offset: torch.Tensor  # per-lane first slot
    size: int


def randomly_select_ris_tile(coherent_rng: rtrng.RngState,
                             params: RISBufferSegmentParameters
                             ) -> tuple[RISTileInfo, rtrng.RngState]:
    """(RISBuffer.hlsli:32-42)."""
    rnd, coherent_rng = rtrng.sample_uniform(coherent_rng)
    tile = (rnd * params.tile_count).to(torch.int64)
    return RISTileInfo(tile * params.tile_size + params.buffer_offset,
                       params.tile_size), coherent_rng


def randomly_select_light_data_from_ris_tile(
        rng: rtrng.RngState, tile: RISTileInfo, ris_buffer: torch.Tensor
) -> tuple[torch.Tensor, rtrng.RngState]:
    """(RISBuffer.hlsli:20-30): the tile slot's [..., 2] uint32 words."""
    rnd, rng = rtrng.sample_uniform(rng)
    sample = torch.clamp_max((rnd * tile.size).to(torch.int64),
                             tile.size - 1)
    return ris_buffer[sample + tile.offset], rng


# ---------------------------------------------------------------------------
# Candidate streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LightSamplingContext:
    """Sampling configuration and the light tables the candidate streams
    read (what the GLSL passes as globals)."""

    lights: LightInfo  # [L] full light table
    light_buffer_params: LightBufferParameters
    local_light_sampling_mode: int = 0  # 0 uniform, 1 power RIS, 2 ReGIR
    enable_presampling: bool = False
    ris_buffer: torch.Tensor | None = None  # [S, 2] uint32 words
    local_ris_params: RISBufferSegmentParameters | None = None
    env_ris_params: RISBufferSegmentParameters | None = None
    # the ReGIR grid (local_light_sampling_mode 2): [cells * per_cell, 2]
    # uint32 words and its regir.ReGIRGridParameters
    regir_ris_buffer: torch.Tensor | None = None
    regir_params: regir_mod.ReGIRGridParameters | None = None


def sample_local_lights(rng, coherent_rng, surface: Surface,
                        sample_params: SampleParameters,
                        ctx: LightSamplingContext, bridge: Bridge):
    """(InitialSamplingFunctions.hlsli:261-343). Returns (reservoir,
    sample, rng, coherent_rng)."""
    shape = tuple(surface.view_depth.shape)
    dev = surface.view_depth.device
    state = empty_di_reservoir(shape, device=dev)
    selected = _empty_light_sample(shape, dev)
    region = ctx.light_buffer_params.local_light_buffer_region
    if region.num_lights == 0 or sample_params.num_local_light_samples == 0:
        return state, selected, rng, coherent_rng
    use_ris = (ctx.enable_presampling and ctx.local_light_sampling_mode == 1
               and ctx.ris_buffer is not None)
    use_regir = (ctx.enable_presampling and ctx.local_light_sampling_mode == 2
                 and ctx.regir_ris_buffer is not None
                 and ctx.regir_params is not None)
    if use_ris:
        tile, coherent_rng = randomly_select_ris_tile(coherent_rng,
                                                      ctx.local_ris_params)
    if use_regir:
        # RTXDI_CalculateReGIRCellIndex (InitialSamplingFunctions.hlsli:
        # 165-183): the grid cell of a jittered sampling position
        jit3, coherent_rng = rtrng.sample_uniform_n(coherent_rng, 3)
        pos = surface.world_pos + (jit3 - 0.5) * regir_mod.get_jitter_scale(
            ctx.regir_params, surface.world_pos)
        regir_cell = regir_mod.world_pos_to_cell_index(ctx.regir_params, pos)

    for _ in range(sample_params.num_local_light_samples):
        if use_regir:
            # lanes inside the grid draw from their cell, the others
            # uniformly; every lane draws both uniforms, as in the JAX
            # package (the shader picks one path per pixel, :211-219)
            li_r, inv_r, valid_r, rng = (
                regir_mod.select_light_from_regir_cell(
                    rng, ctx.regir_ris_buffer, regir_cell, ctx.regir_params))
            rnd, rng = rtrng.sample_uniform(rng)
            light_index = torch.where(valid_r, li_r,
                                      _uniform_index(rnd, region))
            inv_source_pdf = torch.where(valid_r, inv_r,
                                         float(region.num_lights))
        elif use_ris:
            tile_data, rng = randomly_select_light_data_from_ris_tile(
                rng, tile, ctx.ris_buffer)
            light_index = tile_data[..., 0] & 0x7FFFFFFF
            inv_source_pdf = _as_float(tile_data[..., 1])
        else:
            rnd, rng = rtrng.sample_uniform(rng)
            inv_source_pdf = torch.full(shape, float(region.num_lights),
                                        device=dev)
            light_index = _uniform_index(rnd, region)
        light_info = gather_light(ctx.lights, light_index)

        uv, rng = rtrng.sample_uniform_n(rng, 2)
        candidate = bridge.sample_polymorphic_light(light_info, surface, uv)
        blended_pdf = light_brdf_mis_weight(
            bridge, surface, candidate, 1.0 / inv_source_pdf,
            sample_params.local_light_mis_weight, False, sample_params)
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        ris_rnd, rng = rtrng.sample_uniform(rng)
        nonzero = blended_pdf != 0.0
        state, sel = stream_sample(
            state, light_index, uv, ris_rnd, target_pdf,
            1.0 / torch.where(nonzero, blended_pdf, 1.0), active=nonzero)
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0,
                                float(sample_params.num_mis_samples))
    return state._replace(m=torch.ones(shape, device=dev)), selected, rng, \
        coherent_rng


def sample_infinite_lights(rng, surface: Surface, num_samples: int,
                           ctx: LightSamplingContext, bridge: Bridge):
    """(InitialSamplingFunctions.hlsli:378-409). Returns (reservoir,
    sample, rng)."""
    shape = tuple(surface.view_depth.shape)
    dev = surface.view_depth.device
    state = empty_di_reservoir(shape, device=dev)
    selected = _empty_light_sample(shape, dev)
    region = ctx.light_buffer_params.infinite_light_buffer_region
    if region.num_lights == 0 or num_samples == 0:
        return state, selected, rng

    for _ in range(num_samples):
        rnd, rng = rtrng.sample_uniform(rng)
        inv_source_pdf = torch.full(shape, float(region.num_lights),
                                    device=dev)
        light_index = _uniform_index(rnd, region)
        light_info = gather_light(ctx.lights, light_index)
        uv, rng = rtrng.sample_uniform_n(rng, 2)
        candidate = bridge.sample_polymorphic_light(light_info, surface, uv)
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        ris_rnd, rng = rtrng.sample_uniform(rng)
        state, sel = stream_sample(state, light_index, uv, ris_rnd,
                                   target_pdf, inv_source_pdf)
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0, state.m)
    return state._replace(m=torch.ones(shape, device=dev)), selected, rng


def sample_environment_map(rng, coherent_rng, surface: Surface,
                           sample_params: SampleParameters,
                           ctx: LightSamplingContext, bridge: Bridge):
    """(InitialSamplingFunctions.hlsli:465-499; presampling only).
    Returns (reservoir, sample, rng, coherent_rng)."""
    shape = tuple(surface.view_depth.shape)
    dev = surface.view_depth.device
    state = empty_di_reservoir(shape, device=dev)
    selected = _empty_light_sample(shape, dev)
    env = ctx.light_buffer_params.environment_light_params
    if (not ctx.enable_presampling or env.light_present == 0
            or sample_params.num_environment_map_samples == 0
            or ctx.ris_buffer is None):
        return state, selected, rng, coherent_rng

    tile, coherent_rng = randomly_select_ris_tile(coherent_rng,
                                                  ctx.env_ris_params)
    env_index, light_info = _lane_light(ctx, env.light_index, shape, dev)
    for _ in range(sample_params.num_environment_map_samples):
        tile_data, rng = randomly_select_light_data_from_ris_tile(
            rng, tile, ctx.ris_buffer)
        packed_uv = tile_data[..., 0]
        inv_source_pdf = _as_float(tile_data[..., 1])
        uv = torch.stack([(packed_uv & 0xFFFF).to(torch.float32),
                          (packed_uv >> 16).to(torch.float32)],
                         dim=-1) / 65535.0
        candidate = bridge.sample_polymorphic_light(light_info, surface, uv)
        blended_pdf = light_brdf_mis_weight(
            bridge, surface, candidate,
            1.0 / torch.clamp_min(inv_source_pdf, 1e-30),
            sample_params.environment_map_mis_weight, True, sample_params)
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        ris_rnd, rng = rtrng.sample_uniform(rng)
        nonzero = (blended_pdf != 0.0) & (inv_source_pdf > 0.0)
        state, sel = stream_sample(
            state, env_index, uv, ris_rnd, target_pdf,
            1.0 / torch.where(nonzero, blended_pdf, 1.0), active=nonzero)
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0,
                                float(sample_params.num_mis_samples))
    return state._replace(m=torch.ones(shape, device=dev)), selected, rng, \
        coherent_rng


def sample_brdf(rng, surface: Surface, sample_params: SampleParameters,
                ctx: LightSamplingContext, bridge: Bridge):
    """RTXDI_SampleBrdf (InitialSamplingFunctions.hlsli:507-591): sample
    the BRDF, trace the candidate ray (batched), identify the light it hits
    or fall through to the environment. Returns (reservoir, sample, rng)."""
    shape = tuple(surface.view_depth.shape)
    dev = surface.view_depth.device
    state = empty_di_reservoir(shape, device=dev)
    selected = _empty_light_sample(shape, dev)
    env = ctx.light_buffer_params.environment_light_params
    invalid = RTXDI_INVALID_LIGHT_INDEX

    for _ in range(sample_params.num_brdf_samples):
        sample_dir, dir_valid, rng = bridge.get_surface_brdf_sample(
            surface, rng)
        brdf_pdf = bridge.get_surface_brdf_pdf(surface, sample_dir)
        max_dist = brdf_max_distance_from_pdf(sample_params.brdf_cutoff,
                                              brdf_pdf)
        hit_anything, light_index, rand_xy = bridge.trace_ray_for_local_light(
            surface.world_pos, sample_dir,
            torch.full(shape, sample_params.brdf_ray_min_t, device=dev),
            max_dist)
        # lanes with an invalid brdf sample trace nothing
        hit_anything = hit_anything & dir_valid
        light_index = torch.where(dir_valid, light_index, invalid)

        hit_light = light_index != invalid
        light_info = gather_light(ctx.lights,
                                  torch.where(hit_light, light_index, 0))
        candidate_local = bridge.sample_polymorphic_light(
            light_info, surface, rand_xy)
        if sample_params.brdf_cutoff > 0.0:
            to_light = candidate_local.position - surface.world_pos
            dist = torch.linalg.vector_norm(to_light, dim=-1)
            ldir = to_light / torch.clamp_min(dist, 1e-30)[..., None]
            pdf2 = bridge.get_surface_brdf_pdf(surface, ldir)
            hit_light &= dist <= brdf_max_distance_from_pdf(
                sample_params.brdf_cutoff, pdf2)
        local_pdf = torch.where(
            hit_light, bridge.evaluate_local_light_source_pdf(light_index),
            0.0)

        # environment fall-through (:556-564)
        env_case = dir_valid & ~hit_anything & (env.light_present != 0)
        if env.light_present:
            _, env_info = _lane_light(ctx, env.light_index, shape, dev)
            env_uv = brdf.direction_to_equirect_uv(sample_dir)
            candidate_env = bridge.sample_polymorphic_light(
                env_info, surface, env_uv)
            env_pdf = bridge.evaluate_environment_map_sampling_pdf(
                sample_dir)
            candidate = _select_sample(env_case, candidate_env,
                                       candidate_local)
            light_index = torch.where(env_case, env.light_index, light_index)
            rand_xy = torch.where(env_case[..., None], env_uv, rand_xy)
            source_pdf = torch.where(env_case, env_pdf, local_pdf)
        else:
            candidate = candidate_local
            source_pdf = local_pdf

        live = source_pdf != 0.0
        is_env = light_index == env.light_index
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        mis_w_env = light_brdf_mis_weight(
            bridge, surface, candidate, source_pdf,
            sample_params.environment_map_mis_weight, True, sample_params)
        mis_w_local = light_brdf_mis_weight(
            bridge, surface, candidate, source_pdf,
            sample_params.local_light_mis_weight, False, sample_params)
        blended_pdf = torch.where(is_env, mis_w_env, mis_w_local)

        ris_rnd, advanced = rtrng.sample_uniform(rng)
        rng = rtrng.RngState(rng.seed,
                             torch.where(live, advanced.index, rng.index))
        state, sel = stream_sample(
            state, light_index, rand_xy, ris_rnd, target_pdf,
            1.0 / torch.where(blended_pdf != 0, blended_pdf, 1.0),
            active=live & (blended_pdf != 0))
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0,
                                float(sample_params.num_mis_samples))
    return state._replace(m=torch.ones(shape, device=dev)), selected, rng


def sample_lights_for_surface(rng, coherent_rng, surface: Surface,
                              sample_params: SampleParameters,
                              ctx: LightSamplingContext, bridge: Bridge
                              ) -> tuple[DIReservoir, LightSample,
                                         rtrng.RngState, rtrng.RngState]:
    """RTXDI_SampleLightsForSurface (InitialSamplingFunctions.hlsli:594-664):
    RIS-combine the candidate reservoirs of every stream."""
    local_res, local_sample, rng, coherent_rng = sample_local_lights(
        rng, coherent_rng, surface, sample_params, ctx, bridge)
    inf_res, inf_sample, rng = sample_infinite_lights(
        rng, surface, sample_params.num_infinite_light_samples, ctx, bridge)
    if ctx.enable_presampling:
        env_res, env_sample, rng, coherent_rng = sample_environment_map(
            rng, coherent_rng, surface, sample_params, ctx, bridge)
    brdf_res, brdf_sample, rng = sample_brdf(rng, surface, sample_params,
                                             ctx, bridge)

    shape = tuple(surface.view_depth.shape)
    dev = surface.view_depth.device
    state = empty_di_reservoir(shape, device=dev)
    state, _ = combine_reservoirs(state, local_res, 0.5, local_res.target_pdf)
    r1, rng = rtrng.sample_uniform(rng)
    state, sel_inf = combine_reservoirs(state, inf_res, r1,
                                        inf_res.target_pdf)
    if ctx.enable_presampling:
        r2, rng = rtrng.sample_uniform(rng)
        state, sel_env = combine_reservoirs(state, env_res, r2,
                                            env_res.target_pdf)
    r3, rng = rtrng.sample_uniform(rng)
    state, sel_brdf = combine_reservoirs(state, brdf_res, r3,
                                         brdf_res.target_pdf)
    state = finalize_resampling(state, 1.0, 1.0)
    state = state._replace(m=torch.ones(shape, device=dev))

    out = _select_sample(sel_inf, inf_sample, local_sample)
    if ctx.enable_presampling:
        out = _select_sample(sel_env, env_sample, out)
    out = _select_sample(sel_brdf, brdf_sample, out)
    return state, out, rng, coherent_rng
