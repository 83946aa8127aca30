"""Decoders of the G-buffer's packed planes (packing.glsl): the 2x16
unorm octahedral normal, R11G11B10 unorm albedo and the RGBA8 gamma-2.2
specular F0 and roughness; and of a DI reservoir's light and sample words
(DIReservoir.hlsli:29-60, 219-232): bit 31 marks a valid reservoir, bits
0-30 its light index, and the sample's uv is two 16-bit fixed-point
values truncated from [0, 1]. uint32 values held in int64 tensors."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _unorm(v: torch.Tensor, bits: int) -> torch.Tensor:
    mask = (1 << bits) - 1
    return (v & mask).to(torch.float32) / float(mask)


def octahedral_normal(v: torch.Tensor) -> torch.Tensor:
    v = v.long() & M32
    p = torch.stack([torch.clamp((v & 0xFFFF).float() / 65534.0, 0.0, 1.0),
                     torch.clamp((v >> 16).float() / 65534.0, 0.0, 1.0)],
                    -1) * 2.0 - 1.0
    nz = 1.0 - p.abs().sum(-1)
    t = torch.clamp_min(-nz, 0.0)
    nx = p[..., 0] + torch.where(p[..., 0] >= 0, -t, t)
    ny = p[..., 1] + torch.where(p[..., 1] >= 0, -t, t)
    n = torch.stack([nx, ny, nz], -1)
    return n / torch.sqrt((n * n).sum(-1, keepdim=True))


def r11g11b10(v: torch.Tensor) -> torch.Tensor:
    v = v.long() & M32
    return torch.stack([_unorm(v, 11), _unorm(v >> 11, 11),
                        _unorm(v >> 22, 10)], -1)


def rgba8_gamma(v: torch.Tensor) -> torch.Tensor:
    v = v.long() & M32
    e = torch.stack([_unorm(v >> s, 8) for s in (0, 8, 16, 24)], -1)
    return torch.pow(e, 2.2)


def reservoir_light(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(valid [n] bool, light index [n] int64)."""
    v = v.long() & M32
    return v != 0, v & 0x7FFFFFFF


def reservoir_uv(v: torch.Tensor) -> torch.Tensor:
    """[n, 2] the uv's 16-bit codes over 65535: the lower end of the
    interval the stored uv was truncated from."""
    v = v.long() & M32
    return torch.stack([(v & 0xFFFF).float(), (v >> 16).float()],
                       -1) / 65535.0
