"""ReSTIR DI temporal and spatial resampling and the DI boiling filter,
port of raytracer2_tpu/restir/di_resampling.py
(rtxdi/DIResamplingFunctions.hlsli) with all four bias-correction modes
(off / basic / pairwise / ray-traced, RtxdiParameters.h:28-36).

Whole-image and vectorized: each stage is a fixed-trip loop of masked
updates over [H, W] (or [H, W//2]) pixel tensors that gathers neighbours
from whole reservoir planes, and the ray-traced bias correction casts one
full-screen visibility batch per stage (temporal) or per neighbour sample
(spatial) through the bridge. A lane advances its RNG counter only where
the shader's lane would draw, so every stream matches the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer2_tpu_torch.render.surface import (
    Surface, clamp_sample_position_into_view)
from raytracer2_tpu_torch.restir import helpers
from raytracer2_tpu_torch.restir.bridge import Bridge
from raytracer2_tpu_torch.restir.di_reservoir import (
    MAX_M, DIReservoir, _where_res, combine_reservoirs, empty_di_reservoir,
    finalize_resampling, internal_simple_resample, is_valid, light_index,
    sample_uv)
from raytracer2_tpu_torch.utils import rng as rtrng

NAIVE_SAMPLING_M_THRESHOLD = 2  # (DIResamplingFunctions.hlsli:27)


def _gather_di(buf: DIReservoir, x, y) -> DIReservoir:
    """The reservoirs of `buf` [H, W] at (x, y), clamped into the planes."""
    h, w = buf.weight_sum.shape
    xi = torch.clamp(x, 0, w - 1).long()
    yi = torch.clamp(y, 0, h - 1).long()
    return DIReservoir(*(leaf[yi, xi] for leaf in buf))


def _target_pdf_helper(bridge: Bridge, reservoir: DIReservoir,
                       surface: Surface, prior_frame: bool = False):
    """RTXDI_TargetPdfHelper (DIResamplingFunctions.hlsli:30-37)."""
    info = bridge.load_light_info(light_index(reservoir), prior_frame)
    ls = bridge.sample_polymorphic_light(info, surface, sample_uv(reservoir))
    return bridge.get_light_sample_target_pdf(ls, surface), ls


def stream_neighbor_with_pairwise_mis(
        state: DIReservoir, random, neighbor: DIReservoir,
        neighbor_surface: Surface, canonical: DIReservoir,
        canonical_surface: Surface, num_neighbors, bridge: Bridge,
        active) -> tuple[DIReservoir, torch.Tensor]:
    """(DIResamplingFunctions.hlsli:46-83)."""
    n_at_c = torch.clamp_min(
        _target_pdf_helper(bridge, neighbor, canonical_surface)[0], 0.0)
    c_at_n = torch.clamp_min(
        _target_pdf_helper(bridge, canonical, neighbor_surface)[0], 0.0)
    n_at_n = torch.clamp_min(
        _target_pdf_helper(bridge, neighbor, neighbor_surface)[0], 0.0)
    c_at_c = torch.clamp_min(
        _target_pdf_helper(bridge, canonical, canonical_surface)[0], 0.0)

    w0 = helpers.pairwise_mis_weight(
        n_at_n, n_at_c, neighbor.m * num_neighbors, canonical.m)
    w1 = helpers.pairwise_mis_weight(
        c_at_n, c_at_c, neighbor.m * num_neighbors, canonical.m)
    m = neighbor.m * torch.minimum(helpers.m_factor(n_at_n, n_at_c),
                                   helpers.m_factor(c_at_n, c_at_c))
    state = state._replace(canonical_weight=state.canonical_weight
                           + torch.where(active, 1.0 - w1, 0.0))
    return internal_simple_resample(state, neighbor, random, n_at_c,
                                    neighbor.weight_sum * w0, m,
                                    active=active)


def stream_canonical_with_pairwise_step(
        state: DIReservoir, random, canonical: DIReservoir,
        canonical_surface: Surface) -> tuple[DIReservoir, torch.Tensor]:
    """(DIResamplingFunctions.hlsli:88-97)."""
    return internal_simple_resample(
        state, canonical, random, canonical.target_pdf,
        canonical.weight_sum * state.canonical_weight, canonical.m)


def _advance(rng: rtrng.RngState, mask) -> tuple[torch.Tensor,
                                                 rtrng.RngState]:
    """One uniform that only the lanes of `mask` draw."""
    r, adv = rtrng.sample_uniform(rng)
    return r, rtrng.advance_where(rng, adv, mask)


def _select_surface(mask, a: Surface, b: Surface) -> Surface:
    return Surface(*(torch.where(mask[..., None] if x.dim() > mask.dim()
                                 else mask, x, y) for x, y in zip(a, b)))


@dataclasses.dataclass(frozen=True)
class DITemporalSpec:
    max_history_length: int = 5
    bias_correction_mode: int = 2
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_visibility_shortcut: bool = True  # discard_invisible_samples
    enable_permutation_sampling: bool = False
    active_checkerboard_field: int = 0


def di_temporal_resampling(
        px: torch.Tensor, py: torch.Tensor, surface: Surface,
        cur_sample: DIReservoir, rng: rtrng.RngState, spec: DITemporalSpec,
        screen_space_motion: torch.Tensor, uniform_random_number: int,
        prev_reservoirs: DIReservoir, bridge: Bridge, row_base: int = 0
        ) -> tuple[DIReservoir, rtrng.RngState]:
    """RTXDI_DITemporalResampling (DIResamplingFunctions.hlsli:170-360):
    the 9-candidate reprojection search, the merge of the previous
    reservoir and its bias correction. px/py: the launch grid;
    screen_space_motion [..., 3] in pixels; prev_reservoirs [H, W] (or
    [H, W//2] under a checkerboard field), or under row sharding a
    halo-padded row tile whose first row is global row row_base."""
    height = bridge.viewport[1]
    shape = tuple(px.shape)
    dev = px.device

    bias_mode = spec.bias_correction_mode
    if bias_mode == helpers.BIAS_CORRECTION_PAIRWISE:
        bias_mode = helpers.BIAS_CORRECTION_BASIC  # (:181-185)

    history_limit = torch.clamp_max(spec.max_history_length * cur_sample.m,
                                    float(MAX_M))
    state = empty_di_reservoir(shape, device=dev)
    state, _ = combine_reservoirs(state, cur_sample, 0.5,
                                  cur_sample.target_pdf)

    motion = screen_space_motion
    if not spec.enable_permutation_sampling:
        # jitter the reprojection (:204-207): 2 draws on every lane
        jx, rng = rtrng.sample_uniform(rng)
        jy, rng = rtrng.sample_uniform(rng)
        motion = torch.cat([motion[..., 0:1] + (jx - 0.5)[..., None],
                            motion[..., 1:2] + (jy - 0.5)[..., None],
                            motion[..., 2:]], dim=-1)

    prev_x = torch.round(px.to(torch.float32) + motion[..., 0]).to(
        torch.int32)
    prev_y = torch.round(py.to(torch.float32) + motion[..., 1]).to(
        torch.int32)
    expected_prev_depth = surface.view_depth + motion[..., 2]
    radius = 4.0 if spec.active_checkerboard_field == 0 else 8.0
    field = spec.active_checkerboard_field

    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    sel_x, sel_y = prev_x, prev_y
    sel_surface = None
    sel_offset = torch.zeros(shape + (2,), dtype=torch.int32, device=dev)

    # the 9-candidate surface search (:220-254): each candidate after the
    # first draws 2 uniforms on the lanes that have found none yet
    for i in range(9):
        if i == 0:
            ox = torch.zeros(shape, dtype=torch.int32, device=dev)
            oy = ox
        else:
            rx_, rng = _advance(rng, ~found)
            ry_, rng = _advance(rng, ~found)
            # astype(int32) truncates toward zero, as .to(int32) does
            ox = ((rx_ - 0.5) * radius).to(torch.int32)
            oy = ((ry_ - 0.5) * radius).to(torch.int32)
        ix, iy = prev_x + ox, prev_y + oy
        if spec.enable_permutation_sampling and i == 0:
            ix, iy = helpers.apply_permutation_sampling(
                ix, iy, int(uniform_random_number))
        ix, iy = helpers.activate_checkerboard_pixel(ix, iy, True, field)

        t_surface = bridge.get_gbuffer_surface(ix, iy, True)
        ok = t_surface.valid & helpers.is_valid_neighbor(
            surface.normal, t_surface.normal, expected_prev_depth,
            t_surface.view_depth, spec.normal_threshold,
            spec.depth_threshold)
        take = ok & ~found
        sel_x = torch.where(take, ix, sel_x)
        sel_y = torch.where(take, iy, sel_y)
        sel_offset = torch.where(take[..., None], torch.stack([ox, oy], -1),
                                 sel_offset)
        sel_surface = (t_surface if sel_surface is None
                       else _select_surface(take, t_surface, sel_surface))
        found = found | take

    # load and merge the previous reservoir (:259-316); the x clamp is to
    # the reservoir planes' width before the field halves it, as in JAX
    rx, ry = helpers.pixel_pos_to_reservoir_pos(
        torch.clamp(sel_x, 0, prev_reservoirs.weight_sum.shape[1] - 1),
        torch.clamp(sel_y, 0, height - 1), field)
    prev = _gather_di(prev_reservoirs, rx, ry - row_base)
    prev = prev._replace(
        m=torch.minimum(prev.m, history_limit),
        spatial_distance=prev.spatial_distance + sel_offset,
        age=(prev.age + 1) & 0xFFFFFFFF)

    info = bridge.load_light_info(light_index(prev), False)
    candidate = bridge.sample_polymorphic_light(info, surface,
                                                sample_uv(prev))
    weight_at_current = torch.where(
        is_valid(prev), bridge.get_light_sample_target_pdf(candidate,
                                                           surface), 0.0)

    rr, rng = _advance(rng, found)
    prev_m = torch.where(found, prev.m, 0.0)
    state, selected_prev = combine_reservoirs(state, prev, rr,
                                              weight_at_current, active=found)

    if bias_mode >= helpers.BIAS_CORRECTION_BASIC:
        pi = state.target_pdf
        pi_sum = state.target_pdf * cur_sample.m
        use = is_valid(state) & found & (prev_m > 0)
        # the selected sample's pdf at the temporal surface (:329-335)
        sel_info = bridge.load_light_info(light_index(state), True)
        sel_at_temporal = bridge.sample_polymorphic_light(
            sel_info, sel_surface, sample_uv(state))
        temporal_p = bridge.get_light_sample_target_pdf(sel_at_temporal,
                                                        sel_surface)
        if bias_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
            need_ray = (temporal_p > 0) & (
                ~selected_prev | (not spec.enable_visibility_shortcut))
            visible = bridge.get_temporal_conservative_visibility(
                surface, sel_surface, sel_at_temporal.position)
            temporal_p = torch.where(need_ray & ~visible, 0.0, temporal_p)
        pi = torch.where(use & selected_prev, temporal_p, pi)
        pi_sum = pi_sum + torch.where(use, temporal_p * prev_m, 0.0)
        state = finalize_resampling(state, pi, pi_sum)
    else:
        state = finalize_resampling(state, 1.0, state.m)
    return state, rng


@dataclasses.dataclass(frozen=True)
class DISpatialSpec:
    num_samples: int = 3
    num_disocclusion_boost_samples: int = 2
    target_history_length: int = 0
    bias_correction_mode: int = 2
    sampling_radius: float = 32.0
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_material_similarity_test: bool = True
    discount_naive_samples: bool = False
    active_checkerboard_field: int = 0
    neighbor_offset_mask: int = 8191


def di_spatial_resampling(
        px: torch.Tensor, py: torch.Tensor, surface: Surface,
        center_sample: DIReservoir, rng: rtrng.RngState, spec: DISpatialSpec,
        cur_reservoirs: DIReservoir, bridge: Bridge, row_base: int = 0
        ) -> tuple[DIReservoir, rtrng.RngState]:
    """RTXDI_DISpatialResampling (DIResamplingFunctions.hlsli:504-677),
    with the pairwise-MIS variant (:409-494). The disocclusion boost takes
    the static most samples and masks the extra ones per lane; the
    ray-traced bias correction casts one visibility batch per sample.
    Under row sharding cur_reservoirs is a halo-padded row tile whose
    first row is global row row_base; gathers past it clamp to its edge
    rows."""
    width, height = bridge.viewport
    shape = tuple(px.shape)
    dev = px.device
    field = spec.active_checkerboard_field

    max_samples = min(max(spec.num_samples,
                          spec.num_disocclusion_boost_samples), 32)
    boost = center_sample.m < spec.target_history_length
    lane_samples = torch.where(
        boost, max(spec.num_disocclusion_boost_samples, spec.num_samples),
        spec.num_samples).to(torch.int32)
    pairwise = spec.bias_correction_mode == helpers.BIAS_CORRECTION_PAIRWISE

    state = empty_di_reservoir(shape, device=dev)
    if not pairwise:  # pairwise streams the canonical at the end (:482)
        state, _ = combine_reservoirs(state, center_sample, 0.5,
                                      center_sample.target_pdf)

    r0, rng = rtrng.sample_uniform(rng)
    start_idx = (r0 * spec.neighbor_offset_mask).to(torch.int32)

    selected = torch.full(shape, -1, dtype=torch.int32, device=dev)
    cached, neighbor_xy = [], []
    valid_spatial = torch.zeros(shape, dtype=torch.int32, device=dev)

    def neighbor_reservoir(ix, iy):
        rx, ry = helpers.pixel_pos_to_reservoir_pos(ix, iy, field)
        return _gather_di(cur_reservoirs, rx,
                          torch.clamp(ry, 0, height - 1) - row_base)

    for i in range(max_samples):
        in_count = i < lane_samples
        ox, oy = helpers.calculate_spatial_resampling_offset(
            start_idx + i, spec.sampling_radius, bridge.neighbor_offsets,
            spec.neighbor_offset_mask)
        ix, iy = clamp_sample_position_into_view(px + ox, py + oy, width,
                                                 height)
        ix, iy = helpers.activate_checkerboard_pixel(ix, iy, False, field)
        neighbor_xy.append((ix, iy))

        n_surface = bridge.get_gbuffer_surface(ix, iy, False)
        ok = in_count & n_surface.valid & helpers.is_valid_neighbor(
            surface.normal, n_surface.normal, surface.view_depth,
            n_surface.view_depth, spec.normal_threshold,
            spec.depth_threshold)
        if spec.enable_material_similarity_test:
            ok &= bridge.are_materials_similar(surface, n_surface)

        n_res = neighbor_reservoir(ix, iy)
        n_res = n_res._replace(spatial_distance=n_res.spatial_distance
                               + torch.stack([ox, oy], -1))
        if spec.discount_naive_samples:
            ok &= ~(is_valid(n_res)
                    & (n_res.m <= NAIVE_SAMPLING_M_THRESHOLD))
        cached.append(ok)

        if pairwise:
            valid_spatial = valid_spatial + ok.to(torch.int32)
            merge = ok & (n_res.m > 0)
            rr, rng = _advance(rng, merge)
            state, _ = stream_neighbor_with_pairwise_mis(
                state, rr, n_res, n_surface, center_sample, surface,
                lane_samples.to(torch.float32), bridge, active=merge)
        else:
            info = bridge.load_light_info(light_index(n_res), False)
            cand = bridge.sample_polymorphic_light(info, surface,
                                                   sample_uv(n_res))
            weight = torch.where(
                is_valid(n_res),
                bridge.get_light_sample_target_pdf(cand, surface), 0.0)
            rr, rng = _advance(rng, ok)
            state, upd = combine_reservoirs(state, n_res, rr, weight,
                                            active=ok)
            selected = torch.where(upd, i, selected)

    if pairwise:  # (:479-485)
        state = state._replace(canonical_weight=torch.where(
            valid_spatial <= 0, 1.0, state.canonical_weight))
        rr, rng = rtrng.sample_uniform(rng)
        state, _ = stream_canonical_with_pairwise_step(state, rr,
                                                       center_sample, surface)
        state = finalize_resampling(
            state, 1.0, torch.clamp_min(valid_spatial.to(torch.float32), 1.0))
        return state, rng

    ok_state = is_valid(state)
    if spec.bias_correction_mode >= helpers.BIAS_CORRECTION_BASIC:
        pi = state.target_pdf
        pi_sum = state.target_pdf * center_sample.m
        sel_info = bridge.load_light_info(light_index(state), False)
        for i, (ix, iy) in enumerate(neighbor_xy):
            ok = cached[i]
            n_surface = bridge.get_gbuffer_surface(ix, iy, False)
            sel_at_n = bridge.sample_polymorphic_light(sel_info, n_surface,
                                                       sample_uv(state))
            ps = bridge.get_light_sample_target_pdf(sel_at_n, n_surface)
            if spec.bias_correction_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
                visible = bridge.get_conservative_visibility(
                    n_surface, sel_at_n.position)
                ps = torch.where(visible, ps, 0.0)
            n_m = neighbor_reservoir(ix, iy).m
            pi = torch.where(ok & (selected == i), ps, pi)
            pi_sum = pi_sum + torch.where(ok, ps * n_m, 0.0)
        finalized = finalize_resampling(state, pi, pi_sum)
    else:
        finalized = finalize_resampling(state, 1.0, state.m)
    # (:610) the normalization applies to valid reservoirs only
    return state._replace(weight_sum=torch.where(
        ok_state, finalized.weight_sum, state.weight_sum)), rng


def di_spatio_temporal_resampling(
        px, py, surface: Surface, cur_sample: DIReservoir,
        rng: rtrng.RngState, t_spec: DITemporalSpec, s_spec: DISpatialSpec,
        screen_space_motion, uniform_random_number: int,
        prev_reservoirs: DIReservoir, bridge: Bridge, row_base: int = 0
        ) -> tuple[DIReservoir, rtrng.RngState]:
    """RTXDI_DISpatioTemporalResampling (DIResamplingFunctions.hlsli:935+),
    as the JAX package composes it: the temporal merge, then a spatial walk
    whose source is the previous frame's reservoirs (row_base as in both)."""
    merged, rng = di_temporal_resampling(
        px, py, surface, cur_sample, rng, t_spec, screen_space_motion,
        uniform_random_number, prev_reservoirs, bridge, row_base=row_base)
    return di_spatial_resampling(px, py, surface, merged, rng, s_spec,
                                 prev_reservoirs, bridge, row_base=row_base)


def di_boiling_filter(reservoirs: DIReservoir, filter_strength
                      ) -> DIReservoir:
    """RTXDI_BoilingFilter for DI (DIResamplingFunctions.hlsli:101-116):
    empty the reservoirs whose weight sum is far above their 16x16 tile's
    average nonzero one (restir/helpers.py boiling_filter_mask). Takes a
    whole [H, W] reservoir image."""
    kill = helpers.boiling_filter_mask(reservoirs.weight_sum, filter_strength)
    return _where_res(kill, empty_di_reservoir(kill.shape,
                                               device=kill.device),
                      reservoirs)
