"""Primary-ray generation and view-space helpers, port of the part of
raytracer2_tpu/render/rays.py the reference frame and post-process use
(pixel grid, Z-order layout, setupPrimaryRay, environment motion). The
checkerboard fields, tile layouts and G-buffer motion vectors come with the
G-buffer slice (ROADMAP queue A).

Matrix-vector products are written out as elementwise sums over the last
axis, so no float32 product goes through a TF32 path on the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from raytracer2_tpu_torch.params import BACKGROUND_DEPTH, PlanarViewConstants
from raytracer2_tpu_torch.utils.brdf import normalize


class Rays(NamedTuple):
    """SoA ray batch (ref RayDesc: GBufferHelpers.glsl:5-10)."""

    origin: torch.Tensor  # [..., 3]
    direction: torch.Tensor  # [..., 3]
    t_min: torch.Tensor  # [...]
    t_max: torch.Tensor  # [...]


def view_tensor(x, device) -> torch.Tensor:
    """A PlanarViewConstants member as a float32 tensor on `device`."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[r, c] @ [..., c] -> [..., r] as an elementwise sum over c."""
    return (m * v[..., None, :]).sum(dim=-1)


def pixel_grid(width: int, height: int, *, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel coordinates (x, y) as [H, W] int32 tensors."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device), indexing="ij")
    return xs, ys


@lru_cache(maxsize=8)
def zorder_permutation(width: int, height: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Static Z-curve (Morton) pixel layout: (zidx, inv). zidx[j] is the
    row-major index of the j-th pixel in Z order; inv maps back. Launching
    per-pixel rays in Z order makes every bundle a compact screen tile."""
    lin = np.arange(width * height)
    px = (lin % width).astype(np.uint64)
    py = (lin // width).astype(np.uint64)
    code = np.zeros(lin.shape, np.uint64)
    for b in range(16):
        code |= ((px >> b) & 1) << (2 * b)
        code |= ((py >> b) & 1) << (2 * b + 1)
    zidx = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.argsort(zidx, kind="stable").astype(np.int32)
    return zidx, inv


def setup_primary_ray(pixel_x: torch.Tensor, pixel_y: torch.Tensor,
                      view: PlanarViewConstants) -> Rays:
    """Port of setupPrimaryRay (GBufferHelpers.glsl:12-27)."""
    dev = pixel_x.device
    size = view_tensor(view.viewport_size, dev)
    px = pixel_x.to(torch.float32) + 0.5
    py = pixel_y.to(torch.float32) + 0.5
    dx = (px / size[0]) * 2.0 - 1.0
    dy = (py / size[1]) * 2.0 - 1.0

    one = torch.ones_like(dx)
    clip = torch.stack([dx, dy, one, one], dim=-1)
    target = matvec(view_tensor(view.mat_clip_to_view, dev), clip)
    tdir = normalize(target[..., :3])
    world_dir = matvec(view_tensor(view.mat_view_to_world, dev)[:3, :3], tdir)

    origin = view_tensor(view.camera_direction_or_position, dev)[:3] \
        .expand(world_dir.shape)
    return Rays(
        origin=origin,
        direction=world_dir,
        t_min=torch.zeros(world_dir.shape[:-1], device=dev),
        t_max=torch.full(world_dir.shape[:-1], BACKGROUND_DEPTH, device=dev),
    )


def get_environment_motion_vector(view: PlanarViewConstants,
                                  view_prev: PlanarViewConstants,
                                  window_pos: torch.Tensor) -> torch.Tensor:
    """Port of getEnvironmentMotionVector (post_processing.comp:127-146)."""
    dev = window_pos.device
    clip_xy = (view_tensor(view.window_to_clip_scale, dev) * window_pos
               + view_tensor(view.window_to_clip_bias, dev))
    zeros = torch.zeros(window_pos.shape[:-1] + (1,), device=dev)
    clip = torch.cat([clip_xy, zeros, torch.ones_like(zeros)], dim=-1)
    world = matvec(view_tensor(view.mat_clip_to_world, dev), clip)
    prev_clip = matvec(view_tensor(view_prev.mat_world_to_clip, dev), world)
    pw = prev_clip[..., 3:4]
    prev_ndc = prev_clip[..., :2] / torch.where(pw == 0.0, 1.0, pw)
    return (view_tensor(view.clip_to_window_scale, dev) * (prev_ndc - clip_xy)
            + (view_tensor(view.pixel_offset, dev)
               - view_tensor(view_prev.pixel_offset, dev)))
