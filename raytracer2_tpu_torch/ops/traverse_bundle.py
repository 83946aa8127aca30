"""Bundle helpers, port of the part of raytracer2_tpu/ops/traverse_bundle.py
that the closest-hit walk's candidate prep calls: ray padding, the Morton
bit spread and the per-bundle origin box / inverse-direction interval.

The XLA bundle walk itself is not ported: the port's overflow fallback
re-traces through the CUDA walk at full candidate length instead.
"""

from __future__ import annotations

import torch


def _pad_rays(origins, directions, t_min, t_max, multiple: int):
    """Pad the ray batch to a multiple of `multiple` with rays that can
    never hit (t_max = -1). Returns (o, d, tn, tx, n_original)."""
    n = origins.shape[0]
    pad = (-n) % multiple
    if pad:
        dev = origins.device
        origins = torch.cat(
            [origins, torch.zeros((pad, 3), dtype=origins.dtype, device=dev)])
        directions = torch.cat(
            [directions, torch.tensor([[0.0, 0.0, 1.0]], dtype=directions.dtype,
                                      device=dev).expand(pad, 3)])
        t_min = torch.cat(
            [t_min, torch.zeros((pad,), dtype=t_min.dtype, device=dev)])
        t_max = torch.cat(
            [t_max, torch.full((pad,), -1.0, dtype=t_max.dtype, device=dev)])
    return origins, directions, t_min, t_max, n


def _expand_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread the low `bits` bits with 2 zeros between each (morton helper);
    int64 tensors holding uint32 values."""
    v = v & ((1 << bits) - 1)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _bundle_bounds(origins, directions, t_max, bundle_size: int):
    """Per-bundle origin AABB + conservative 1/d interval. Padded rays
    (t_max < 0) are excluded from the bounds via +-big sentinels."""
    b = origins.shape[0] // bundle_size
    o = origins.reshape(b, bundle_size, 3)
    d = directions.reshape(b, bundle_size, 3)
    tm = t_max.reshape(b, bundle_size)
    live = (tm >= 0.0)[..., None]

    big = 3e38
    o_min = torch.where(live, o, big).amin(dim=1)
    o_max = torch.where(live, o, -big).amax(dim=1)
    d_min = torch.where(live, d, big).amin(dim=1)
    d_max = torch.where(live, d, -big).amax(dim=1)

    # conservative reciprocal interval; sign change across the bundle ->
    # unbounded axis (inf sentinels understood by the overlap test)
    spans_zero = (d_min <= 0.0) & (d_max >= 0.0)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12,
                           torch.where(x >= 0, 1e-12, -1e-12), x)

    inv_a = 1.0 / safe(d_min)
    inv_b = 1.0 / safe(d_max)
    inv_lo = torch.minimum(inv_a, inv_b)
    inv_hi = torch.maximum(inv_a, inv_b)
    inv_lo = torch.where(spans_zero, -torch.inf, inv_lo)
    inv_hi = torch.where(spans_zero, torch.inf, inv_hi)

    bundle_tmax = torch.where(live[..., 0], tm, 0.0).amax(dim=1)
    return o_min, o_max, inv_lo, inv_hi, bundle_tmax
