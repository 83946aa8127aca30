"""Row banding of whole-image passes: above a lane threshold a pass body
runs on row bands of the [H, W] grid, which bounds its temporaries. Every
RNG stream of the passes is seeded by pixel coordinates, so banding a pass
that reads no neighbour changes no value. Each band run counts once on
the program's counter "band" (utils/profiler.py)."""

from __future__ import annotations

import torch

from raytracer2_tpu_torch.utils.profiler import count

BAND_LANES = 1 << 21  # most lanes of one band


def _rows(x, r0: int, r1: int):
    """Rows [r0, r1) of a tensor or of every tensor of a (named) tuple."""
    if isinstance(x, tuple):
        parts = [_rows(f, r0, r1) for f in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x[r0:r1]


def _cat_rows(parts):
    """Concatenate row bands of tensors or of (named) tuples of them."""
    if isinstance(parts[0], tuple):
        cols = [_cat_rows(list(f)) for f in zip(*parts)]
        return (type(parts[0])(*cols) if hasattr(parts[0], "_fields")
                else tuple(cols))
    return torch.cat(parts)


def banded(body, height: int, width: int, threshold: int, *grids):
    """body(*grids) on the whole [H, W] grid, or row band by row band (of
    about half the threshold's lanes, at most BAND_LANES) above `threshold`
    lanes. grids: [H, W, ...] tensors or (named) tuples of them."""
    if height * width <= threshold:
        return body(*grids)
    hb = max(1, min(BAND_LANES, threshold // 2) // max(width, 1))
    parts = []
    for r in range(0, height, hb):
        count("band")
        parts.append(body(*(_rows(g, r, r + hb) for g in grids)))
    return _cat_rows(parts)
