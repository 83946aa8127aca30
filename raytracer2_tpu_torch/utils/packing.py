"""Z-curve (Morton) index math, port of the part of
raytracer2_tpu/utils/packing.py that the RNG seeding calls.

torch's uint32 has only partial operator support, so uint32 values are
carried in int64 tensors holding [0, 2**32); every left shift is masked
back to 32 bits. The UFLOAT, gamma, f16, octahedral and LogLuv encodings
come with the G-buffer and DI slices (ROADMAP queue A).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its value mod 2**32."""
    return x.to(torch.int64) & M32


def integer_explode(x: torch.Tensor) -> torch.Tensor:
    """Insert 0 between each of the low 16 bits (ref: RtxdiMath.hlsli:33-40)."""
    x = as_u32(x)
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def zcurve_to_linear(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x, y) -> Z-curve linear index (ref: RtxdiMath.hlsli:55-58)."""
    return (integer_explode(x) | (integer_explode(y) << 1)) & M32
