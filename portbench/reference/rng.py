"""The renderer's per-pixel random numbers (Helpers.glsl:13-64: a Jenkins
hash of the pixel's Z-curve index plus the frame seeds a murmur3 counter;
RtxdiMath.hlsli:33-79). uint32 arithmetic in int64 tensors masked to 32
bits."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def _explode(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _jenkins(a: torch.Tensor) -> torch.Tensor:
    a = ((a + 0x7ED55D16) + (a << 12)) & M32
    a = (a ^ 0xC761C23C) ^ (a >> 19)
    a = ((a + 0x165667B1) + (a << 5)) & M32
    a = ((a + 0xD3A2646C) ^ ((a << 9) & M32)) & M32
    a = ((a + 0xFD7046C5) + (a << 3)) & M32
    return (a ^ 0xB55A4F09) ^ (a >> 16)


def seed(px: torch.Tensor, py: torch.Tensor, frame_index: int) -> torch.Tensor:
    """The sampler's seed; its counter starts at 1."""
    z = (_explode(px.long()) | (_explode(py.long()) << 1)) & M32
    return (_jenkins(z) + (int(frame_index) & M32)) & M32


def _rot(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def uniform(seed_: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The float in [0, 1) that draw `index` of the sampler gives."""
    k = _mul(_rot(_mul(index & M32, 0xCC9E2D51), 15), 0x1B873593)
    h = (_mul(_rot(seed_ ^ k, 13), 5) + 0xE6546B64) & M32
    h = h ^ 4
    h = _mul(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    bits = (h & ((1 << 23) - 1)) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
