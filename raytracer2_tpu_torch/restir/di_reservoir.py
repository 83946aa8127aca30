"""DI light reservoirs and the streaming RIS core, port of
raytracer2_tpu/restir/di_reservoir.py (rtxdi/DIReservoir.hlsli).

A reservoir is a NamedTuple of per-pixel tensors; RTXDI_StreamSample,
RTXDI_InternalSimpleResample, RTXDI_CombineDIReservoirs and
RTXDI_FinalizeResampling (DIReservoir.hlsli:241-340) are elementwise
masked updates over the whole image. The packed 24-byte form
(RTXDI_PackedDIReservoir, RtxdiParameters.h:96-104) keeps the reference's
bit layout. uint32 words are int64 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Packing constants (DIReservoir.hlsli:62-80)
VISIBILITY_MASK = 0x3FFFF
VISIBILITY_CHANNEL_MAX = 0x3F
VISIBILITY_CHANNEL_SHIFT = 6
M_SHIFT = 18
MAX_M = 0x3FFF
DISTANCE_CHANNEL_BITS = 8
DISTANCE_X_SHIFT = 0
DISTANCE_Y_SHIFT = 8
AGE_SHIFT = 16
MAX_AGE = 0xFF
DISTANCE_MASK = (1 << DISTANCE_CHANNEL_BITS) - 1
MAX_DISTANCE = (1 << (DISTANCE_CHANNEL_BITS - 1)) - 1
LIGHT_VALID_BIT = 0x80000000
LIGHT_INDEX_MASK = 0x7FFFFFFF
FLT_MIN_NORMAL = float(torch.finfo(torch.float32).tiny)


class DIReservoir(NamedTuple):
    """RTXDI_DIReservoir (DIReservoir.hlsli:29-60), SoA over pixels."""

    light_data: torch.Tensor  # [...] u32: light index | valid bit
    uv_data: torch.Tensor  # [...] u32: 2x16 fixed-point sample uv
    weight_sum: torch.Tensor  # [...] f32 (RIS wsum, then invPdf)
    target_pdf: torch.Tensor  # [...] f32
    m: torch.Tensor  # [...] f32
    packed_visibility: torch.Tensor  # [...] u32
    spatial_distance: torch.Tensor  # [..., 2] i32
    age: torch.Tensor  # [...] u32
    canonical_weight: torch.Tensor  # [...] f32


def empty_di_reservoir(shape, *, device) -> DIReservoir:
    """(DIReservoir.hlsli:117-130)."""
    shape = tuple(shape)

    def z(dtype, extra=()):
        return torch.zeros(shape + extra, dtype=dtype, device=device)

    return DIReservoir(
        light_data=z(torch.int64), uv_data=z(torch.int64),
        weight_sum=z(torch.float32), target_pdf=z(torch.float32),
        m=z(torch.float32), packed_visibility=z(torch.int64),
        spatial_distance=z(torch.int32, (2,)), age=z(torch.int64),
        canonical_weight=z(torch.float32))


def is_valid(res: DIReservoir) -> torch.Tensor:
    """(DIReservoir.hlsli:219-222)."""
    return res.light_data != 0


def light_index(res: DIReservoir) -> torch.Tensor:
    """(DIReservoir.hlsli:224-227)."""
    return res.light_data & LIGHT_INDEX_MASK


def sample_uv(res: DIReservoir) -> torch.Tensor:
    """(DIReservoir.hlsli:229-232)."""
    return torch.stack([(res.uv_data & 0xFFFF).to(torch.float32),
                        (res.uv_data >> 16).to(torch.float32)], dim=-1) / 65535.0


def inv_pdf(res: DIReservoir) -> torch.Tensor:
    """(DIReservoir.hlsli:234-237)."""
    return res.weight_sum


def _u16(x: torch.Tensor) -> torch.Tensor:
    """A float in [0, 65535] truncated to an integer (astype(uint32))."""
    return x.to(torch.int64)


def stream_sample(res: DIReservoir, new_light_index: torch.Tensor,
                  uv: torch.Tensor, random: torch.Tensor,
                  target_pdf: torch.Tensor, inv_source_pdf: torch.Tensor,
                  active: torch.Tensor | None = None
                  ) -> tuple[DIReservoir, torch.Tensor]:
    """Streaming weighted reservoir sampling, Algorithm 3
    (DIReservoir.hlsli:241-271); inactive lanes pass through unchanged.
    Returns (reservoir, selected)."""
    if active is None:
        active = torch.ones_like(res.weight_sum, dtype=torch.bool)
    ris_weight = target_pdf * inv_source_pdf
    m = res.m + torch.where(active, 1.0, 0.0)
    weight_sum = res.weight_sum + torch.where(active, ris_weight, 0.0)
    select = active & (random * weight_sum < ris_weight)
    uv_packed = (_u16(torch.clamp(uv[..., 0], 0, 1) * 65535.0)
                 | (_u16(torch.clamp(uv[..., 1], 0, 1) * 65535.0) << 16))
    out = res._replace(
        light_data=torch.where(select, new_light_index | LIGHT_VALID_BIT,
                               res.light_data),
        uv_data=torch.where(select, uv_packed, res.uv_data),
        weight_sum=weight_sum,
        target_pdf=torch.where(select, target_pdf, res.target_pdf),
        m=m)
    return out, select


def _where_res(mask: torch.Tensor, a: DIReservoir, b: DIReservoir
               ) -> DIReservoir:
    """Select reservoir fields lane-wise: mask ? a : b."""
    return DIReservoir(*(torch.where(mask[..., None] if x.dim() > mask.dim()
                                     else mask, x, y) for x, y in zip(a, b)))


def internal_simple_resample(res: DIReservoir, new_res: DIReservoir,
                             random: torch.Tensor, target_pdf,
                             sample_normalization, sample_m,
                             active: torch.Tensor | None = None
                             ) -> tuple[DIReservoir, torch.Tensor]:
    """RTXDI_InternalSimpleResample (DIReservoir.hlsli:277-310); inactive
    lanes pass through unchanged. Returns (reservoir, selected)."""
    ris_weight = target_pdf * sample_normalization
    if active is None:
        m = res.m + sample_m
        weight_sum = res.weight_sum + ris_weight
        select = random * weight_sum < ris_weight
    else:
        m = res.m + torch.where(active, sample_m, 0.0)
        weight_sum = res.weight_sum + torch.where(active, ris_weight, 0.0)
        select = active & (random * weight_sum < ris_weight)
    s2 = select[..., None]
    out = res._replace(
        light_data=torch.where(select, new_res.light_data, res.light_data),
        uv_data=torch.where(select, new_res.uv_data, res.uv_data),
        weight_sum=weight_sum,
        target_pdf=torch.where(select, target_pdf, res.target_pdf),
        m=m,
        packed_visibility=torch.where(select, new_res.packed_visibility,
                                      res.packed_visibility),
        spatial_distance=torch.where(s2, new_res.spatial_distance,
                                     res.spatial_distance),
        age=torch.where(select, new_res.age, res.age))
    return out, select


def combine_reservoirs(res: DIReservoir, new_res: DIReservoir,
                       random: torch.Tensor, target_pdf: torch.Tensor,
                       active: torch.Tensor | None = None
                       ) -> tuple[DIReservoir, torch.Tensor]:
    """Algorithm 4, combining streams (DIReservoir.hlsli:315-329)."""
    return internal_simple_resample(res, new_res, random, target_pdf,
                                    new_res.weight_sum * new_res.m,
                                    new_res.m, active)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """x with subnormal values flushed to zero, as on the devices that
    flush float32 subnormals (XLA's CPU and TPU backends)."""
    return torch.where(torch.abs(x) < FLT_MIN_NORMAL, 0.0, x)


def finalize_resampling(res: DIReservoir, normalization_numerator,
                        normalization_denominator) -> DIReservoir:
    """Equation 6 normalization (DIReservoir.hlsli:332-340). Its two
    products flush subnormals to zero, as XLA's CPU and TPU backends do:
    the products of two target pdfs near 1e-19 must give weight 0, not a
    weight that a subnormal numerator or denominator puts anywhere."""
    denominator = _flush(res.target_pdf * normalization_denominator)
    zero = denominator == 0.0
    new_w = torch.where(
        zero, 0.0, _flush(res.weight_sum * normalization_numerator)
        / torch.where(zero, 1.0, denominator))
    return res._replace(weight_sum=new_w)


def store_visibility(res: DIReservoir, visibility: torch.Tensor,
                     discard_if_invisible: bool, active: torch.Tensor
                     ) -> DIReservoir:
    """(DIReservoir.hlsli:164-182)."""
    v = torch.clamp(visibility, 0.0, 1.0)
    packed = (_u16(v[..., 0] * VISIBILITY_CHANNEL_MAX)
              | (_u16(v[..., 1] * VISIBILITY_CHANNEL_MAX)
                 << VISIBILITY_CHANNEL_SHIFT)
              | (_u16(v[..., 2] * VISIBILITY_CHANNEL_MAX)
                 << (VISIBILITY_CHANNEL_SHIFT * 2)))
    invisible = (visibility == 0.0).all(dim=-1)
    discard = active & invisible & discard_if_invisible
    return res._replace(
        light_data=torch.where(discard, 0, res.light_data),
        weight_sum=torch.where(discard, 0.0, res.weight_sum),
        packed_visibility=torch.where(active, packed, res.packed_visibility),
        spatial_distance=torch.where(active[..., None], 0,
                                     res.spatial_distance),
        age=torch.where(active, 0, res.age))


def get_reservoir_visibility(res: DIReservoir, max_age, max_distance
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(DIReservoir.hlsli:199-217). Returns (reusable mask, visibility)."""
    dist = torch.linalg.vector_norm(res.spatial_distance.to(torch.float32),
                                    dim=-1)
    ok = (res.age > 0) & (res.age <= max_age) & (dist < max_distance)
    pv = res.packed_visibility
    vis = torch.stack(
        [((pv >> (i * VISIBILITY_CHANNEL_SHIFT)) & VISIBILITY_CHANNEL_MAX)
         .to(torch.float32) / float(VISIBILITY_CHANNEL_MAX)
         for i in range(3)], dim=-1)
    return ok, torch.where(ok[..., None], vis, 0.0)


# ---------------------------------------------------------------------------
# Packed form (the bit layout of RTXDI_PackedDIReservoir)
# ---------------------------------------------------------------------------

class PackedDIReservoir(NamedTuple):
    """(RtxdiParameters.h:96-104): 6 32-bit words."""

    light_data: torch.Tensor  # u32
    uv_data: torch.Tensor  # u32
    m_visibility: torch.Tensor  # u32
    distance_age: torch.Tensor  # u32
    target_pdf: torch.Tensor  # f32
    weight: torch.Tensor  # f32


def pack_di_reservoir(res: DIReservoir) -> PackedDIReservoir:
    """(DIReservoir.hlsli:82-103)."""
    sd = torch.clamp(res.spatial_distance.to(torch.int64), -MAX_DISTANCE,
                     MAX_DISTANCE)
    m_vis = res.packed_visibility | (
        torch.clamp_max(res.m.to(torch.int64), MAX_M) << M_SHIFT)
    dist_age = (((sd[..., 0] & DISTANCE_MASK) << DISTANCE_X_SHIFT)
                | ((sd[..., 1] & DISTANCE_MASK) << DISTANCE_Y_SHIFT)
                | (torch.clamp_max(res.age, MAX_AGE) << AGE_SHIFT))
    return PackedDIReservoir(
        light_data=res.light_data, uv_data=res.uv_data,
        m_visibility=m_vis, distance_age=dist_age,
        target_pdf=res.target_pdf, weight=res.weight_sum)


def unpack_di_reservoir(p: PackedDIReservoir) -> DIReservoir:
    """(DIReservoir.hlsli:132-153), with the discard of a non-finite
    weight."""
    def sext(word, shift):  # the signed 8-bit channel at `shift`
        v = (word >> shift) & DISTANCE_MASK
        return torch.where(v > MAX_DISTANCE, v - (1 << DISTANCE_CHANNEL_BITS),
                           v).to(torch.int32)

    res = DIReservoir(
        light_data=p.light_data, uv_data=p.uv_data, weight_sum=p.weight,
        target_pdf=p.target_pdf,
        m=((p.m_visibility >> M_SHIFT) & MAX_M).to(torch.float32),
        packed_visibility=p.m_visibility & VISIBILITY_MASK,
        spatial_distance=torch.stack(
            [sext(p.distance_age, DISTANCE_X_SHIFT),
             sext(p.distance_age, DISTANCE_Y_SHIFT)], dim=-1),
        age=(p.distance_age >> AGE_SHIFT) & MAX_AGE,
        canonical_weight=torch.zeros_like(p.weight))
    bad = ~torch.isfinite(res.weight_sum)
    return _where_res(bad, empty_di_reservoir(bad.shape, device=bad.device),
                      res)
