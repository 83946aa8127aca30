"""Halo exchange for row-sharded image passes, port of
raytracer2_tpu/parallel/halo.py.

The resampling passes gather from bounded pixel stencils (GI spatial
radius 3 px, DI spatial radius 32 px, reference main.rs:264,353; temporal
reprojection bounded by the motion). A rank pads its row tile with
`radius` rows of each neighbouring rank's tile; the image's outer edges
reflect, as the reference clamps spatial neighbours at the screen's edges
(RtxdiApplicationBridge.glsl:252-265). JAX's ring ppermute wraps the
first and last tile around and then discards what wrapped; here the
first and last rank simply exchange nothing across the image's edge.

    padded = exchange_row_halos(tile, radius, mesh)  # [h_local + 2r, ...]
    values = gather_rows(padded, radius, dy, dx)     # stencil reads
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from raytracer2_tpu_torch.parallel.mesh import RowMesh, staged


def _reflect_top(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Rows above the image: the first rows mirrored (row r-1 .. 0)."""
    return x[:radius].flip(0)


def _reflect_bottom(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Rows below the image: the last rows mirrored."""
    return x[x.shape[0] - radius:].flip(0)


def local_pad_rows(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Reflect-pad a tile with its own rows: the shapes and work of
    exchange_row_halos with no transfer (wrong at inner tile edges), so
    the difference of the two times is the exchange's cost."""
    return torch.cat([_reflect_top(x, radius), x, _reflect_bottom(x, radius)])


def exchange_row_halos(x: torch.Tensor, radius: int,
                       mesh: RowMesh) -> torch.Tensor:
    """Pad this rank's row tile x [h_local, ...] with `radius` rows from
    each neighbouring rank's tile, reflected at the image's outer edges:
    [h_local + 2 radius, ...]. Every rank of the mesh must call it with
    the same radius. The sends and receives to both neighbours go in one
    batch_isend_irecv, so no order of the ranks deadlocks; under gloo each
    halo goes through a contiguous host copy."""
    # a radius past the tile height would misalign the halo: the slices
    # below would hold fewer rows than the callers' offsets assume
    assert radius <= x.shape[0], (
        f"halo radius {radius} exceeds the tile height {x.shape[0]}; use "
        "more rows per tile or a smaller stencil radius")
    top, bottom = _reflect_top(x, radius), _reflect_bottom(x, radius)
    if mesh.size == 1 or radius == 0:
        return torch.cat([top, x, bottom])
    ops, recv = [], {}
    h = x.shape[0]
    for side, peer, rows in (("above", mesh.rank - 1, x[:radius]),
                             ("below", mesh.rank + 1, x[h - radius:])):
        if 0 <= peer < mesh.size:
            send = staged(mesh, rows)
            buf = torch.empty_like(send)
            recv[side] = buf
            ops.append(dist.P2POp(dist.isend, send, mesh.ranks[peer],
                                  mesh.group))
            ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[peer],
                                  mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if "above" in recv:
        top = recv["above"].to(x.device)
    if "below" in recv:
        bottom = recv["below"].to(x.device)
    return torch.cat([top, x, bottom])


def gather_rows(padded: torch.Tensor, radius: int, dy, dx) -> torch.Tensor:
    """Stencil gather over a halo-padded tile: for every tile pixel (y, x)
    the value at (y + dy, x + dx), dy in [-radius, radius] (inside the
    halo) and x + dx clamped to the image width (columns are whole)."""
    h = padded.shape[0] - 2 * radius
    w = padded.shape[1]
    dev = padded.device
    ys = torch.arange(h, device=dev)[:, None] + radius + dy
    xs = torch.clamp(torch.arange(w, device=dev)[None, :] + dx, 0, w - 1)
    return padded[ys, xs]
