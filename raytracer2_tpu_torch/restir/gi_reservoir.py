"""GI sample reservoirs, port of raytracer2_tpu/restir/gi_reservoir.py
(rtxdi/GIReservoir.hlsli): the SoA reservoir and its packed 32-byte form
(position f32x3, snorm2x16 oct normal, LogLuv radiance, age/M byte
fields). uint32 fields are int64 tensors holding [0, 2**32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.utils import packing as pk

MAX_M = 0xFF  # (GIReservoir.hlsli:52-56)
MAX_AGE = 0xFF
M_SHIFT = 0
AGE_SHIFT = 8
MISC_DATA_MASK = 0xFFFF0000


class GIReservoir(NamedTuple):
    """RTXDI_GIReservoir (GIReservoir.hlsli:29-49), SoA over pixels."""

    position: torch.Tensor  # [..., 3] secondary-surface position
    normal: torch.Tensor  # [..., 3]
    radiance: torch.Tensor  # [..., 3]
    weight_sum: torch.Tensor  # [...]
    m: torch.Tensor  # [...] u32
    age: torch.Tensor  # [...] u32


def empty_gi_reservoir(shape, *, device) -> GIReservoir:
    """(GIReservoir.hlsli:168-180)."""
    shape = tuple(shape)

    def zeros(extra=(), dtype=torch.float32):
        return torch.zeros(shape + extra, dtype=dtype, device=device)

    return GIReservoir(position=zeros((3,)), normal=zeros((3,)),
                       radiance=zeros((3,)), weight_sum=zeros(),
                       m=zeros(dtype=torch.int64), age=zeros(dtype=torch.int64))


def is_valid(res: GIReservoir) -> torch.Tensor:
    """(GIReservoir.hlsli:182-185)."""
    return res.m != 0


def where_gi(mask: torch.Tensor, a: GIReservoir, b: GIReservoir
             ) -> GIReservoir:
    """Per lane, a where mask else b."""
    return GIReservoir(*(
        torch.where(mask[..., None] if x.dim() > mask.dim() else mask, x, y)
        for x, y in zip(a, b)))


def make_gi_reservoir(position: torch.Tensor, normal: torch.Tensor,
                      radiance: torch.Tensor, sample_pdf: torch.Tensor
                      ) -> GIReservoir:
    """RTXDI_MakeGIReservoir (GIResamplingFunctions.hlsli:97-127 in the
    reference tree): a fresh single-sample reservoir; weightSum = 1/pdf."""
    live = sample_pdf > 0.0
    return GIReservoir(
        position=position, normal=normal, radiance=radiance,
        weight_sum=torch.where(live, 1.0 / torch.clamp_min(sample_pdf, 1e-30),
                               0.0),
        m=live.to(torch.int64), age=torch.zeros_like(live, dtype=torch.int64))


class PackedGIReservoir(NamedTuple):
    """(ReSTIRGIParameters.h packed struct): 8 u32 words / 32 bytes."""

    position: torch.Tensor  # [..., 3] f32
    packed_normal: torch.Tensor  # u32 snorm2x16 oct
    weight: torch.Tensor  # f32
    packed_radiance: torch.Tensor  # u32 LogLuv
    packed_misc_age_m: torch.Tensor  # u32
    unused: torch.Tensor  # u32


def pack_gi_reservoir(res: GIReservoir, misc_data: int = 0
                      ) -> PackedGIReservoir:
    """(GIReservoir.hlsli:66-83)."""
    packed_misc = ((misc_data & MISC_DATA_MASK)
                   | (torch.clamp_max(res.age, MAX_AGE) << AGE_SHIFT)
                   | (torch.clamp_max(res.m, MAX_M) << M_SHIFT))
    return PackedGIReservoir(
        position=res.position,
        packed_normal=pk.encode_normal_snorm2x16(res.normal),
        weight=res.weight_sum,
        packed_radiance=pk.encode_rgb_to_logluv(res.radiance),
        packed_misc_age_m=packed_misc,
        unused=torch.zeros_like(packed_misc))


def unpack_gi_reservoir(p: PackedGIReservoir) -> GIReservoir:
    """(GIReservoir.hlsli:87-105)."""
    misc = pk.as_u32(p.packed_misc_age_m)
    return GIReservoir(
        position=p.position,
        normal=pk.decode_normal_snorm2x16(p.packed_normal),
        radiance=pk.decode_logluv_to_rgb(p.packed_radiance),
        weight_sum=p.weight,
        m=(misc >> M_SHIFT) & MAX_M,
        age=(misc >> AGE_SHIFT) & MAX_AGE)
