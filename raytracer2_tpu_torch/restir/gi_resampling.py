"""ReSTIR GI temporal and spatial resampling over whole pixel tensors, port
of raytracer2_tpu/restir/gi_resampling.py (rtxdi/GIResamplingFunctions.hlsli).

The per-pixel loops with break/continue are fixed-trip masked iterations,
reservoir loads are gathers on [H, W] SoA tensors, and the bias-correction
visibility ray of mode 3 is one batched occlusion query over all lanes per
pass (the bridge's get_(temporal_)conservative_visibility).

RNG parity: lanes that skip a draw in the shader (failed tests, early
break) also skip advancing their murmur3 counter here.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer2_tpu_torch.render.surface import (
    Surface, clamp_sample_position_into_view)
from raytracer2_tpu_torch.restir import helpers
from raytracer2_tpu_torch.restir.bridge import (
    Bridge, validate_gi_sample_with_jacobian)
from raytracer2_tpu_torch.restir.gi_reservoir import (
    GIReservoir, empty_gi_reservoir, is_valid, where_gi)
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.brdf import dot3, luminance_rec709, saturate


def _gather_reservoir(buf: GIReservoir, x, y) -> GIReservoir:
    """Per-lane reservoirs gathered from a [H, W] SoA buffer."""
    x, y = x.long(), y.long()
    return GIReservoir(*(f[y, x] for f in buf))


def _gather_clamped(buf: GIReservoir, rx, ry, height: int, row_base
                    ) -> GIReservoir:
    """Reservoirs at reservoir positions (rx, ry), clamped to the buffer's
    extent (under checkerboard the buffer is [H, W//2] while the viewport
    is full width); row_base maps global rows into a row tile."""
    h, w = buf.weight_sum.shape
    return _gather_reservoir(
        buf, torch.clamp(rx, 0, w - 1),
        torch.clamp(torch.clamp(ry, 0, height - 1) - row_base, 0, h - 1))


def combine_gi_reservoirs(res: GIReservoir, new_res: GIReservoir, random,
                          target_pdf, active=None
                          ) -> tuple[GIReservoir, torch.Tensor]:
    """RTXDI_CombineGIReservoirs (GIResamplingFunctions.hlsli:28-55)."""
    if active is None:
        active = torch.ones(res.weight_sum.shape, dtype=torch.bool,
                            device=res.weight_sum.device)
    ris_weight = target_pdf * new_res.weight_sum * new_res.m.to(torch.float32)
    m = res.m + torch.where(active, new_res.m, 0)
    weight_sum = res.weight_sum + torch.where(active, ris_weight, 0.0)
    select = active & (random * weight_sum <= ris_weight)
    sel3 = select[..., None]
    out = GIReservoir(
        position=torch.where(sel3, new_res.position, res.position),
        normal=torch.where(sel3, new_res.normal, res.normal),
        radiance=torch.where(sel3, new_res.radiance, res.radiance),
        weight_sum=weight_sum, m=m,
        age=torch.where(select, new_res.age, res.age))
    return out, select


def finalize_gi_resampling(res: GIReservoir, numerator, denominator
                           ) -> GIReservoir:
    """(GIResamplingFunctions.hlsli:58-64)."""
    denominator = torch.as_tensor(denominator, dtype=torch.float32,
                                  device=res.weight_sum.device)
    zero = denominator == 0.0
    w = torch.where(zero, 0.0, res.weight_sum * numerator
                    / torch.where(zero, 1.0, denominator))
    return res._replace(weight_sum=w)


def calculate_jacobian(receiver_pos, neighbor_receiver_pos,
                       neighbor_res: GIReservoir) -> torch.Tensor:
    """Solid-angle reuse Jacobian (GIResamplingFunctions.hlsli:67-93)."""
    def partial(recv):
        vec = recv - neighbor_res.position
        dist = torch.linalg.vector_norm(vec, dim=-1)
        cos = saturate(dot3(neighbor_res.normal,
                            vec / torch.clamp_min(dist, 1e-30)[..., None]))
        return dist, cos

    new_dist, new_cos = partial(receiver_pos)
    orig_dist, orig_cos = partial(neighbor_receiver_pos)
    denom = orig_cos * new_dist * new_dist
    jac = (new_cos * orig_dist * orig_dist) / torch.clamp_min(denom, 1e-30)
    jac = torch.where(denom <= 0.0, 0.0, jac)
    return torch.where(torch.isfinite(jac), jac, 0.0)


@dataclasses.dataclass(frozen=True)
class GITemporalSpec:
    """The static part of GITemporalResamplingParameters (the motion and
    the random number are arguments)."""

    max_history_length: int = 20
    bias_correction_mode: int = 2
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_permutation_sampling: bool = False
    enable_fallback_sampling: bool = True
    active_checkerboard_field: int = 0


def gi_temporal_resampling(
    px: torch.Tensor,  # [N] current pixel positions
    py: torch.Tensor,
    surface: Surface,  # current-frame surfaces at (px, py)
    input_reservoir: GIReservoir,  # [N]
    rng_state: rtrng.RngState,
    spec: GITemporalSpec,
    screen_space_motion: torch.Tensor,  # [N, 3] pixel-space motion
    uniform_random_number: int,
    max_reservoir_age,  # [N] or scalar (jittered per pixel by the caller)
    prev_reservoirs: GIReservoir,  # [H, W] source buffer (previous frame)
    bridge: Bridge,
    row_base=0,  # global row of the source tile's first row
) -> tuple[GIReservoir, rtrng.RngState]:
    """RTXDI_GITemporalResampling (GIResamplingFunctions.hlsli:186-359)."""
    width, height = bridge.viewport
    n = px.shape[0]
    dev = px.device
    field = spec.active_checkerboard_field

    prev_x = torch.round(px.to(torch.float32)
                         + screen_space_motion[..., 0]).to(torch.int32)
    prev_y = torch.round(py.to(torch.float32)
                         + screen_space_motion[..., 1]).to(torch.int32)
    expected_prev_depth = surface.view_depth + screen_space_motion[..., 2]
    radius = 1 if field == 0 else 2

    r, rng_state = rtrng.sample_uniform(rng_state)
    start_idx = (r * 8).to(torch.int32)

    found = torch.zeros(n, dtype=torch.bool, device=dev)
    sel_surface = None  # temporal surface of the found sample
    sel_res = empty_gi_reservoir((n,), device=dev)

    temporal_sample_count = 5
    sample_count = temporal_sample_count + int(spec.enable_fallback_sampling)
    for i in range(sample_count):
        is_first = i == 0
        is_fallback = i == temporal_sample_count
        base_x, base_y = (px, py) if is_fallback else (prev_x, prev_y)
        if is_first or is_fallback:
            ix, iy = base_x, base_y
        else:
            ox, oy = helpers.calculate_temporal_resampling_offset(
                start_idx + i, radius)
            ix, iy = base_x + ox, base_y + oy
        if (spec.enable_permutation_sampling and is_first) or is_fallback:
            ix, iy = helpers.apply_permutation_sampling(
                ix, iy, uniform_random_number)
        ix, iy = helpers.activate_checkerboard_pixel(ix, iy, True, field)

        t_surface = bridge.get_gbuffer_surface(ix, iy, True)
        ok = t_surface.valid
        if not is_fallback:
            ok &= helpers.is_valid_neighbor(
                surface.normal, t_surface.normal, expected_prev_depth,
                t_surface.view_depth, spec.normal_threshold,
                spec.depth_threshold)
        ok &= bridge.are_materials_similar(surface, t_surface)

        rx, ry = helpers.pixel_pos_to_reservoir_pos(ix, iy, field)
        t_res = _gather_clamped(prev_reservoirs, rx, ry, height, row_base)
        ok &= is_valid(t_res)

        take = ok & ~found
        if sel_surface is None:
            sel_surface = t_surface
        else:
            sel_surface = Surface(*(
                torch.where(take[..., None] if a.dim() > take.dim() else take,
                            a, b) for a, b in zip(t_surface, sel_surface)))
        sel_res = where_gi(take, t_res, sel_res)
        found = found | take

    # start with the input reservoir (random = 0.5, :277-282)
    cur = empty_gi_reservoir((n,), device=dev)
    input_valid = is_valid(input_reservoir)
    in_pdf = bridge.get_gi_sample_target_pdf(
        input_reservoir.position, input_reservoir.radiance, surface)
    selected_target_pdf = torch.where(input_valid, in_pdf, 0.0)
    cur, _ = combine_gi_reservoirs(cur, input_reservoir, 0.5, in_pdf,
                                   active=input_valid)

    # jacobian / history clamps on the temporal sample (:284-304)
    jac = calculate_jacobian(surface.world_pos, sel_surface.world_pos, sel_res)
    jac_ok, jac = validate_gi_sample_with_jacobian(jac)
    found &= jac_ok
    sel_res = sel_res._replace(
        weight_sum=sel_res.weight_sum * jac,
        m=torch.clamp_max(sel_res.m, spec.max_history_length),
        age=sel_res.age + 1)
    found &= sel_res.age <= torch.as_tensor(max_reservoir_age, device=dev)

    # temporal merge (1 conditional RNG draw, :306-318)
    t_pdf = bridge.get_gi_sample_target_pdf(
        sel_res.position, sel_res.radiance, surface)
    rr, advanced = rtrng.sample_uniform(rng_state)
    rng_state = rtrng.advance_where(rng_state, advanced, found)
    cur, selected_prev = combine_gi_reservoirs(cur, sel_res, rr, t_pdf,
                                               active=found)
    selected_target_pdf = torch.where(selected_prev, t_pdf,
                                      selected_target_pdf)

    if spec.bias_correction_mode >= helpers.BIAS_CORRECTION_BASIC:
        # MIS-like normalization (:320-348)
        pi = selected_target_pdf
        pi_sum = selected_target_pdf * input_reservoir.m.to(torch.float32)
        use = is_valid(cur) & found
        temporal_p = bridge.get_gi_sample_target_pdf(
            cur.position, cur.radiance, sel_surface)
        if spec.bias_correction_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
            # one batched visibility query (previous surface -> sample)
            visible = bridge.get_temporal_conservative_visibility(
                surface, sel_surface, cur.position)
            temporal_p = torch.where(visible, temporal_p, 0.0)
        pi = torch.where(use & selected_prev, temporal_p, pi)
        pi_sum = pi_sum + torch.where(
            use, temporal_p * sel_res.m.to(torch.float32), 0.0)
        cur = finalize_gi_resampling(cur, pi, pi_sum * selected_target_pdf)
    else:
        cur = finalize_gi_resampling(
            cur, 1.0, selected_target_pdf * cur.m.to(torch.float32))
    return cur, rng_state


@dataclasses.dataclass(frozen=True)
class GISpatialSpec:
    """The static part of GISpatialResamplingParameters."""

    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    num_samples: int = 1
    sampling_radius: float = 3.0
    bias_correction_mode: int = 2
    active_checkerboard_field: int = 0
    neighbor_offset_mask: int = 8191


def gi_spatial_resampling(
    px: torch.Tensor,
    py: torch.Tensor,
    surface: Surface,
    input_reservoir: GIReservoir,
    rng_state: rtrng.RngState,
    spec: GISpatialSpec,
    cur_reservoirs: GIReservoir,  # [H, W] source buffer (current frame)
    bridge: Bridge,
    row_base=0,
) -> tuple[GIReservoir, rtrng.RngState]:
    """RTXDI_GISpatialResampling (GIResamplingFunctions.hlsli:391-553)."""
    width, height = bridge.viewport
    n = px.shape[0]
    dev = px.device
    field = spec.active_checkerboard_field

    cur = empty_gi_reservoir((n,), device=dev)
    input_valid = is_valid(input_reservoir)
    in_pdf = bridge.get_gi_sample_target_pdf(
        input_reservoir.position, input_reservoir.radiance, surface)
    selected_target_pdf = torch.where(input_valid, in_pdf, 0.0)
    cur, _ = combine_gi_reservoirs(cur, input_reservoir, 0.5, in_pdf,
                                   active=input_valid)

    r, rng_state = rtrng.sample_uniform(rng_state)
    start_idx = (r * spec.neighbor_offset_mask).to(torch.int32)

    selected = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cached = []  # per-neighbour merge masks (the cachedResult bits)
    neighbors = []  # (surface, reservoir) per neighbour for the normalization

    for i in range(spec.num_samples):
        ox, oy = helpers.calculate_spatial_resampling_offset(
            start_idx + i, spec.sampling_radius, bridge.neighbor_offsets,
            spec.neighbor_offset_mask)
        ix, iy = clamp_sample_position_into_view(px + ox, py + oy, width,
                                                 height)
        ix, iy = helpers.activate_checkerboard_pixel(ix, iy, False, field)

        n_surface = bridge.get_gbuffer_surface(ix, iy, False)
        ok = helpers.is_valid_neighbor(
            surface.normal, n_surface.normal, surface.view_depth,
            n_surface.view_depth, spec.normal_threshold, spec.depth_threshold)
        ok &= bridge.are_materials_similar(surface, n_surface)

        rx, ry = helpers.pixel_pos_to_reservoir_pos(ix, iy, field)
        n_res = _gather_clamped(cur_reservoirs, rx, ry, height, row_base)
        ok &= is_valid(n_res)
        neighbors.append((n_surface, n_res))

        jac = calculate_jacobian(surface.world_pos, n_surface.world_pos,
                                 n_res)
        t_pdf = bridge.get_gi_sample_target_pdf(
            n_res.position, n_res.radiance, surface)
        jac_ok, jac = validate_gi_sample_with_jacobian(jac)
        ok &= jac_ok
        cached.append(ok)

        rr, advanced = rtrng.sample_uniform(rng_state)
        rng_state = rtrng.advance_where(rng_state, advanced, ok)
        cur, updated = combine_gi_reservoirs(cur, n_res, rr, t_pdf * jac,
                                             active=ok)
        selected = torch.where(updated, i, selected)
        selected_target_pdf = torch.where(updated, t_pdf, selected_target_pdf)

    if spec.bias_correction_mode >= helpers.BIAS_CORRECTION_BASIC:
        pi = selected_target_pdf
        pi_sum = selected_target_pdf * input_reservoir.m.to(torch.float32)
        for i, ((n_surface, n_res), ok) in enumerate(zip(neighbors, cached)):
            ps = bridge.get_gi_sample_target_pdf(
                cur.position, cur.radiance, n_surface)
            if spec.bias_correction_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
                visible = bridge.get_conservative_visibility(
                    n_surface, cur.position)
                ps = torch.where(visible, ps, 0.0)
            pi = torch.where(ok & (selected == i), ps, pi)
            pi_sum = pi_sum + torch.where(
                ok, ps * n_res.m.to(torch.float32), 0.0)
        cur = finalize_gi_resampling(cur, pi, selected_target_pdf * pi_sum)
    else:
        cur = finalize_gi_resampling(
            cur, 1.0, cur.m.to(torch.float32) * selected_target_pdf)
    return cur, rng_state


def gi_boiling_filter(reservoirs: GIReservoir, filter_strength
                      ) -> GIReservoir:
    """RTXDI_GIBoilingFilter (GIResamplingFunctions.hlsli:885-894) over a
    full [H, W] reservoir image."""
    weight = luminance_rec709(reservoirs.radiance) * reservoirs.weight_sum
    kill = helpers.boiling_filter_mask(weight, filter_strength)
    return where_gi(kill, empty_gi_reservoir(weight.shape,
                                             device=weight.device),
                    reservoirs)


def gi_spatio_temporal_resampling(
    px: torch.Tensor,
    py: torch.Tensor,
    surface: Surface,
    input_reservoir: GIReservoir,
    rng_state: rtrng.RngState,
    t_spec: GITemporalSpec,
    s_spec: GISpatialSpec,
    screen_space_motion: torch.Tensor,
    uniform_random_number: int,
    max_reservoir_age,
    prev_reservoirs: GIReservoir,
    bridge: Bridge,
    row_base=0,
) -> tuple[GIReservoir, rtrng.RngState]:
    """RTXDI_GISpatioTemporalResampling (GIResamplingFunctions.hlsli:
    611-880), as the JAX package composes it: the temporal merge, then a
    spatial walk over the previous-frame reservoirs."""
    merged, rng_state = gi_temporal_resampling(
        px, py, surface, input_reservoir, rng_state, t_spec,
        screen_space_motion, uniform_random_number, max_reservoir_age,
        prev_reservoirs, bridge, row_base=row_base)
    return gi_spatial_resampling(
        px, py, surface, merged, rng_state, s_spec, prev_reservoirs, bridge,
        row_base=row_base)
