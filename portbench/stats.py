"""The arithmetic the benchmark's readers share: the window's mean frame,
a nearest-rank percentile, the union of the device's busy intervals and
its idle gaps, and the least time a cull kernel (B3, B4 of
raytracer2_tpu_torch) could take: its roofline bound."""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, at the full 700 W power limit: HBM3 bytes/s
# and FP32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one (live ray, box) slab test of the cull kernels: 6
# subtracts, 6 multiplies, 6 mins/maxes per axis pair, 4 across the axes,
# 3 compares of the hit test, the clamp at 0 and the reduction's compare
# (a ray with t_max < 0 needs none)
SLAB_TEST_OPS = 27


def window_mean_ms(window_s: float, frames: int) -> float:
    """The window's wall time over the frames completed in it, in ms."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return window_s / frames * 1e3


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q% of the values do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(1, math.ceil(q / 100.0 * len(xs))) - 1]


def union_busy(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(intervals) -> list[tuple[float, float]]:
    """The gaps between the union's pieces, in time order."""
    gaps, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def cull_bound_s(rays: int, live_rays: int, boxes: int, out_elems: int
                 ) -> float:
    """The least time the card could take for one cull call: the larger of
    its bytes over the HBM rate and its FP32 operations over the FP32
    rate. Bytes: [rays, 8] float32 rays and the [boxes, 3] min and max
    corners read once, the float32 or int32 output written once.
    Operations: SLAB_TEST_OPS per (live ray, box)."""
    nbytes = rays * 8 * 4 + boxes * 2 * 3 * 4 + out_elems * 4
    ops = live_rays * boxes * SLAB_TEST_OPS
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
