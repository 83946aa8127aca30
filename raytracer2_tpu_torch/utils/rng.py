"""Counter-based per-pixel RNG, bit-exact port of raytracer2_tpu/utils/rng.py
(the reference's murmur3 sampler, src/shaders/Helpers.glsl:13-64).

uint32 arithmetic is emulated in int64 tensors holding [0, 2**32): every
add, multiply and left shift is masked back to 32 bits. Multiplies split
the constant into 16-bit halves so no intermediate leaves int64's range
(signed overflow is not something to lean on in a device kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.utils.packing import M32, as_u32, zcurve_to_linear


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) and a Python int constant c."""
    lo = c & 0xFFFF
    hi = (c >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def jenkins_hash(a: torch.Tensor) -> torch.Tensor:
    """32-bit Jenkins integer hash (ref: rtxdi/RtxdiMath.hlsli:69-79)."""
    a = as_u32(a)
    a = ((a + 0x7ED55D16) + (a << 12)) & M32
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & M32
    a = ((a + 0x165667B1) + (a << 5)) & M32
    a = ((a + 0xD3A2646C) ^ ((a << 9) & M32)) & M32
    a = ((a + 0xFD7046C5) + (a << 3)) & M32
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & M32
    return a


class RngState(NamedTuple):
    """Functional murmur3 sampler state (ref: Helpers.glsl:7-11); both
    members are int64 tensors holding uint32 values."""

    seed: torch.Tensor
    index: torch.Tensor


def init_random_sampler(pixel_x: torch.Tensor, pixel_y: torch.Tensor,
                        frame_index: int) -> RngState:
    """Seed one sampler per pixel (ref: Helpers.glsl:13-23).

    `frame_index` is `frame + pass * 13` at call sites that mirror
    RAB_InitRandomSampler (RtxdiApplicationBridge.glsl:378-381).
    """
    linear = zcurve_to_linear(pixel_x, pixel_y)
    seed = (jenkins_hash(linear) + (int(frame_index) & M32)) & M32
    return RngState(seed=seed, index=torch.ones_like(seed))


def _rot32(x: torch.Tensor, y: int) -> torch.Tensor:
    return ((x << y) & M32) | (x >> (32 - y))


def murmur3(state: RngState) -> tuple[torch.Tensor, RngState]:
    """One murmur3 finalizer step; returns (bits, new_state)
    (ref: Helpers.glsl:25-56)."""
    h = state.seed
    k = mul_u32(state.index, 0xCC9E2D51)
    k = _rot32(k, 15)
    k = mul_u32(k, 0x1B873593)

    h = h ^ k
    h = (mul_u32(_rot32(h, 13), 5) + 0xE6546B64) & M32

    h = h ^ 4
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)

    return h, RngState(seed=state.seed, index=(state.index + 1) & M32)


def sample_uniform(state: RngState) -> tuple[torch.Tensor, RngState]:
    """Uniform float in [0, 1); returns (value, new_state)
    (ref: Helpers.glsl:58-64): asfloat((mask & v) | asuint(1.f)) - 1.f."""
    v, state = murmur3(state)
    mantissa = (v & ((1 << 23) - 1)) | 0x3F800000
    f = mantissa.to(torch.int32).view(torch.float32) - 1.0
    return f, state


def advance_where(state: RngState, advanced: RngState, mask: torch.Tensor
                  ) -> RngState:
    """The state after a draw that only the lanes of `mask` made (the
    shader's lanes that skip a draw keep their counter)."""
    return RngState(seed=state.seed,
                    index=torch.where(mask, advanced.index, state.index))


def sample_uniform_n(state: RngState, n: int
                     ) -> tuple[torch.Tensor, RngState]:
    """Draw n uniforms; returns (values stacked on axis -1, new_state)."""
    vals = []
    for _ in range(n):
        v, state = sample_uniform(state)
        vals.append(v)
    return torch.stack(vals, dim=-1), state


# ---------------------------------------------------------------------------
# The simple LCG-ish generator from common.glsl (used by the legacy helpers)
# ---------------------------------------------------------------------------

def next_random(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PCG-style hash step (ref: src/shaders/common.glsl:39-44)."""
    state = (mul_u32(as_u32(state), 747796405) + 2891336453) & M32
    result = mul_u32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    result = (result >> 22) ^ result
    return result, state


def random_value(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform [0,1] from the PCG step (ref: common.glsl:46-48)."""
    bits, state = next_random(state)
    return bits.to(torch.float32) / 4294967295.0, state
