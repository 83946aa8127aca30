"""Pixel-row sharding of the frame over torch.distributed ranks, port of
raytracer2_tpu/parallel/mesh.py.

JAX shards the frame over a 1-D device mesh inside one program
(shard_map, one row tile per device). Here every rank is a process: it
renders rows [row0, row0 + h_local) of the frame with row0 = rank *
h_local, holds that tile of every [H, ...] leaf of the frame state, and
exchanges halo rows with its neighbours through the process group
(parallel/halo.py). The scene and its tables are whole on every rank.

The process group's backend is named, never guessed: "nccl" when each rank
owns a CUDA device, "gloo" otherwise (CPU ranks, or ranks that share one
card, which NCCL refuses; gloo's transfers are staged through host
copies). Only the explicit-halo path is ported: JAX's GSPMD path
(explicit_halo=False) is a compiler's choice of collectives that has no
counterpart outside XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

ROW_AXIS = "rows"
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D mesh over image rows: the process group, this process's rank
    in it, its size, the backend, and the global rank of each group rank
    (the peers of point-to-point transfers)."""

    group: object
    rank: int
    size: int
    backend: str
    ranks: tuple[int, ...]


def make_mesh(backend: str, group=None) -> RowMesh:
    """The row mesh over `group` (None: the default group), whose backend
    must be `backend`, "nccl" or "gloo". torch.distributed must already be
    initialised."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(dist.init_process_group)")
    got = dist.get_backend(group)
    if got != backend:
        raise ValueError(f"the process group's backend is {got!r}, "
                         f"not {backend!r}")
    size = dist.get_world_size(group)
    ranks = tuple(dist.get_global_rank(group, r) if group is not None else r
                  for r in range(size))
    return RowMesh(group=group, rank=dist.get_rank(group), size=size,
                   backend=backend, ranks=ranks)


def tree_map(fn, tree):
    """fn over the tensors of nested tuples and named tuples."""
    if isinstance(tree, tuple):
        out = [tree_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def row_tile(mesh: RowMesh, height: int) -> tuple[int, int]:
    """(row0, h_local) of this rank's tile of an image of `height` rows."""
    if height % mesh.size:
        raise ValueError(f"{height} image rows do not divide over "
                         f"{mesh.size} ranks")
    h_local = height // mesh.size
    return mesh.rank * h_local, h_local


def shard_frame_state(state, mesh: RowMesh):
    """This rank's tile of a whole-frame FrameState: every leaf whose
    leading dimension is the image height is cut to the rank's rows, the
    rest kept whole (JAX's _image_leaf_sharding)."""
    height = state.gbuffer.depth.shape[0]
    row0, h_local = row_tile(mesh, height)

    def tile(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == height:
            return leaf[row0:row0 + h_local].clone()
        return leaf

    return tree_map(tile, state)


def staged(mesh: RowMesh, x: torch.Tensor) -> torch.Tensor:
    """x as the process group takes it, contiguous: gloo moves host
    tensors only."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" else x


def gather_frame(tile: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The whole image from every rank's row tile, on every rank, on the
    tile's device: the counterpart of JAX's out_specs=P(ROW_AXIS)."""
    src = staged(mesh, tile)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(tile.device)


def psum_image_metric(values: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The sum of `values` over the whole image, from every rank's tile:
    the one all-reduce a whole-image metric needs."""
    total = staged(mesh, values.sum())
    dist.all_reduce(total, group=mesh.group)
    return total.to(values.device)


def make_sharded_render_fn(renderer, mesh: RowMesh,
                           explicit_halo: bool = True, halo_rows: int = 8,
                           halo_impl: str = "exchange") -> Callable:
    """step(g_const, state_tile) -> (state_tile, image_tile): one frame of
    this rank's row tile (shard_frame_state), the stencil passes reading
    their neighbours through halo_rows rows exchanged with the adjacent
    ranks (halo.exchange_row_halos; the image's outer edges reflect).
    Pixel RNG and the view math stay global, so the tiles make the
    single-device frame wherever no read leaves its halo.

    halo_rows is capped at the tile height: a halo borrows from the
    adjacent tile only. halo_impl="local" pads each tile with its own
    reflected rows instead (halo.local_pad_rows): the same work with no
    transfer, wrong at the tiles' inner edges, for timing the exchange.
    step.halo_telemetry counts, for the last frame, the leaves exchanged
    and the bytes a rank sends. explicit_halo=False, JAX's GSPMD path, is
    not ported (its collectives are XLA's choice)."""
    from raytracer2_tpu_torch.parallel.halo import (
        exchange_row_halos, local_pad_rows)
    from raytracer2_tpu_torch.render.frame import render_frame

    if not explicit_halo:
        raise NotImplementedError(
            "explicit_halo=False is JAX's GSPMD path, whose collectives are "
            "XLA's choice and which is not ported: use the explicit-halo "
            "row tiles")
    if halo_impl not in ("exchange", "local"):
        raise ValueError(f"halo_impl must be 'exchange' or 'local', "
                         f"not {halo_impl!r}")
    row0, h_local = row_tile(mesh, renderer.height)
    halo_rows = min(halo_rows, h_local)
    telemetry = {"halo_rows": halo_rows, "halo_exchanges": 0,
                 "halo_bytes_per_device_frame": 0}

    def halo_fn(tree, radius):
        for leaf in tree_leaves(tree):
            row_bytes = (leaf.numel() // max(leaf.shape[0], 1)
                         * leaf.element_size())
            telemetry["halo_exchanges"] += 1
            telemetry["halo_bytes_per_device_frame"] += 2 * radius * row_bytes
        if halo_impl == "local":
            return tree_map(lambda a: local_pad_rows(a, radius), tree)
        return tree_map(lambda a: exchange_row_halos(a, radius, mesh), tree)

    def step(g_const, state):
        if state.gbuffer.depth.shape[0] != h_local:
            raise ValueError(
                f"rank {mesh.rank} holds {state.gbuffer.depth.shape[0]} rows, "
                f"not its tile's {h_local} (shard_frame_state)")
        telemetry["halo_exchanges"] = 0
        telemetry["halo_bytes_per_device_frame"] = 0
        return render_frame(renderer, g_const, state, row0=row0,
                            halo_fn=halo_fn, halo_rows=halo_rows)

    step.halo_telemetry = telemetry
    step.row0, step.h_local = row0, h_local
    return step
