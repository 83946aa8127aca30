"""Shared resampling helpers, port of raytracer2_tpu/restir/helpers.py
(rtxdi/RtxdiHelpers.hlsli and the neighbour/validity math of
rtxdi/RtxdiMath.hlsli), vectorized over pixel tensors. The resampling
passes of the later slices read them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raytracer2_tpu_torch.params import RTXDI_RESERVOIR_BLOCK_SIZE

RTXDI_TILE_SIZE_IN_PIXELS = 16  # (InitialSamplingFunctions.hlsli:25-27)

# Bias-correction modes (RtxdiParameters.h:28-36)
BIAS_CORRECTION_OFF = 0
BIAS_CORRECTION_BASIC = 1
BIAS_CORRECTION_PAIRWISE = 2
BIAS_CORRECTION_RAY_TRACED = 3


def compare_relative_difference(reference, candidate, threshold):
    """(RtxdiMath.hlsli:18-21)."""
    return ((threshold <= 0)
            | (torch.abs(reference - candidate)
               <= threshold * torch.maximum(reference, candidate)))


def is_valid_neighbor(our_norm, their_norm, our_depth, their_depth,
                      normal_threshold, depth_threshold):
    """Edge-stopping similarity test (RtxdiMath.hlsli:25-29)."""
    ndot = (our_norm * their_norm).sum(dim=-1)
    return ((ndot >= normal_threshold)
            & compare_relative_difference(our_depth, their_depth,
                                          depth_threshold))


def m_factor(q0, q1):
    """Pairwise-MIS M multiplier (RtxdiMath.hlsli:104-109)."""
    r = torch.clamp(torch.pow(torch.clamp_max(
        q1 / torch.clamp_min(q0, 1e-30), 1.0), 8.0), 0.0, 1.0)
    return torch.where(q0 <= 0.0, 1.0, r)


def pairwise_mis_weight(w0, w1, m0, m1):
    """Balance-heuristic pairwise MIS weight (RtxdiMath.hlsli:112-117)."""
    denom = m0 * w0 + m1 * w1
    bad = denom <= 0.0
    return torch.where(bad, 0.0, torch.clamp_min(m0 * w0, 0.0)
                       / torch.where(bad, 1.0, denom))


# ---------------------------------------------------------------------------
# Checkerboard-field pixel decomposition (RtxdiHelpers.hlsli:16-61)
# ---------------------------------------------------------------------------

def is_active_checkerboard_pixel(px, py, previous_frame: bool, field: int):
    """(RtxdiHelpers.hlsli:16-25)."""
    if field == 0:
        return torch.ones_like(px, dtype=torch.bool)
    return ((px + py + int(previous_frame)) & 1) == (field & 1)


def activate_checkerboard_pixel(px, py, previous_frame: bool, field: int):
    """(RtxdiHelpers.hlsli:27-43). Returns the shifted (px, py)."""
    if field == 0:
        return px, py
    active = is_active_checkerboard_pixel(px, py, previous_frame, field)
    if previous_frame:
        px_new = px + (field * 2 - 3)
    else:
        px_new = px + torch.where((py & 1) != 0, 1, -1)
    return torch.where(active, px, px_new), py


def pixel_pos_to_reservoir_pos(px, py, field: int):
    """(RtxdiHelpers.hlsli:45-51)."""
    if field == 0:
        return px, py
    return px >> 1, py


def reservoir_pos_to_pixel_pos(rx, ry, field: int):
    """(RtxdiHelpers.hlsli:53-61)."""
    if field == 0:
        return rx, ry
    return (rx << 1) + ((ry + field) & 1), ry


def apply_permutation_sampling(px, py, uniform_random_number: int):
    """(RtxdiHelpers.hlsli:64-73)."""
    ox = uniform_random_number & 3
    oy = (uniform_random_number >> 2) & 3
    return ((px + ox) ^ 3) - ox, ((py + oy) ^ 3) - oy


def reservoir_position_to_pointer(reservoir_params, rx, ry,
                                  reservoir_array_index):
    """Block-linear reservoir addressing (RtxdiHelpers.hlsli:75-88)."""
    bs = RTXDI_RESERVOIR_BLOCK_SIZE
    return (reservoir_array_index * reservoir_params.reservoir_array_pitch
            + (ry // bs) * reservoir_params.reservoir_block_row_pitch
            + (rx // bs) * (bs * bs) + (ry % bs) * bs + (rx % bs))


def calculate_temporal_resampling_offset(sample_idx, radius):
    """8-point pattern around a pixel (GIResamplingFunctions.hlsli:113-130)."""
    s = sample_idx & 7
    mask2 = (s >> 1) & 1
    mask4 = 1 - ((s >> 2) & 1)
    tmp0 = -1 + 2 * (s & 1)
    tmp1 = 1 - 2 * mask2
    tmp2 = mask4 | mask2
    tmp3 = mask4 | (1 - mask2)
    return tmp0 * tmp2 * radius, tmp0 * tmp1 * tmp3 * radius


def calculate_spatial_resampling_offset(sample_idx, radius, neighbor_offsets,
                                        neighbor_offset_mask):
    """Low-discrepancy disk offset (GIResamplingFunctions.hlsli:132-136)."""
    off = neighbor_offsets[(sample_idx & neighbor_offset_mask).long()] * radius
    return off[..., 0].to(torch.int32), off[..., 1].to(torch.int32)


def boiling_filter_mask(weight: torch.Tensor, filter_strength,
                        group_size: int = 16) -> torch.Tensor:
    """Boiling filter (RtxdiHelpers.hlsli:97-151): kill reservoirs whose
    weight exceeds a multiple of the average nonzero weight of their 16x16
    pixel group, the group reduction as a block pooling. weight: [H, W]."""
    h, w = weight.shape
    wpad = F.pad(weight, (0, (-w) % group_size, 0, (-h) % group_size))
    hh, ww = wpad.shape
    blocks = wpad.reshape(hh // group_size, group_size, ww // group_size,
                          group_size)
    wsum = blocks.sum(dim=(1, 3))
    count = (blocks > 0).sum(dim=(1, 3))
    avg = torch.where(count > 0, wsum / torch.clamp_min(count, 1), 0.0)
    avg_full = avg.repeat_interleave(group_size, 0).repeat_interleave(
        group_size, 1)[:h, :w]
    multiplier = 10.0 / min(max(float(filter_strength), 1e-6), 1.0) - 9.0
    return weight > avg_full * multiplier
