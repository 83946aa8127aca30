"""Primary-ray generation and view-space helpers, port of
raytracer2_tpu/render/rays.py: pixel grids (checkerboard fields
included), the Z-order and 8x16-tile coherent layouts, setupPrimaryRay,
viewDepthToWorldPos and the motion vectors. The pixel-space motion
conversion serves GI temporal resampling and comes with that slice.

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
from raytracer2_tpu_torch.utils.readback import upload


class Rays(NamedTuple):
    """SoA ray batch (ref RayDesc: GBufferHelpers.glsl:5-10)."""

    origin: torch.Tensor  # [..., 3]
    direction: torch.Tensor  # [..., 3]
    t_min: torch.Tensor  # [...]
    t_max: torch.Tensor  # [...]


def view_tensor(x, device) -> torch.Tensor:
    """A PlanarViewConstants member as a float32 tensor on `device` (one
    upload per value: a frame reads each member many times)."""
    a = np.asarray(x, np.float32)
    return _view_constant(a.tobytes(), a.shape, device)


@lru_cache(maxsize=256)
def _view_constant(data: bytes, shape: tuple, device) -> torch.Tensor:
    # keyed by the bytes, so -0.0 and 0.0 stay apart
    return upload(np.frombuffer(data, np.float32).reshape(shape).copy(),
                  device)


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


def active_pixel_grid(width: int, height: int, field: int, *, device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates of the checkerboard launch grid: the full [H, W]
    grid for field 0, else the active half-field as [H, W//2] tensors
    (column r is pixel x = 2r + ((y + field) & 1), RtxdiHelpers.hlsli:53-61)."""
    if field == 0:
        return pixel_grid(width, height, device=device)
    if width % 2:
        raise ValueError("checkerboard rendering needs an even width")
    rx, ys = pixel_grid(width // 2, height, device=device)
    return (rx << 1) + ((ys + field) & 1), ys


def gather_field(img: torch.Tensor, field: int) -> torch.Tensor:
    """The active checkerboard field of a full-res [H, W, ...] tensor as
    [H, W//2, ...] (identity when field == 0)."""
    if field == 0:
        return img
    b = field & 1
    out = torch.empty((img.shape[0], img.shape[1] // 2) + img.shape[2:],
                      dtype=img.dtype, device=img.device)
    out[0::2] = img[0::2, b::2]
    out[1::2] = img[1::2, 1 - b::2]
    return out


def scatter_field(full: torch.Tensor, half: torch.Tensor, field: int
                  ) -> torch.Tensor:
    """Write the active field's [H, W//2, ...] values into a copy of a
    full-res tensor, leaving inactive pixels untouched."""
    if field == 0:
        return half
    b = field & 1
    full = full.clone()
    full[0::2, b::2] = half[0::2]
    full[1::2, 1 - b::2] = half[1::2]
    return full


TILE_H = 8  # pixel-tile height of the coherent ray layout


def tile_shape(width: int, height: int, bundle: int = 128
               ) -> tuple[int, int] | None:
    """(tile_h, tile_w) of the reshape-expressible coherent layout, or None
    when the viewport doesn't divide. One tile is one `bundle`-ray bundle;
    256-ray bundles take two horizontally adjacent tiles."""
    th = TILE_H
    tw = bundle // th
    if height % th == 0 and width % tw == 0 and bundle % th == 0:
        return th, tw
    return None


def tile_flatten(img: torch.Tensor, tile_w: int, tile_h: int = TILE_H
                 ) -> torch.Tensor:
    """[H, W, ...] -> [H*W, ...] such that every consecutive tile_h*tile_w
    chunk is one compact screen tile (row-major tile order)."""
    h, w = img.shape[0], img.shape[1]
    rest = img.shape[2:]
    x = img.reshape(h // tile_h, tile_h, w // tile_w, tile_w, *rest)
    return x.transpose(1, 2).reshape((h * w,) + rest)


def tile_unflatten(flat: torch.Tensor, height: int, width: int, tile_w: int,
                   tile_h: int = TILE_H) -> torch.Tensor:
    """Inverse of tile_flatten: [H*W, ...] tile order -> [H, W, ...]."""
    rest = flat.shape[1:]
    x = flat.reshape(height // tile_h, width // tile_w, tile_h, tile_w,
                     *rest)
    return x.transpose(1, 2).reshape((height, width) + rest)


@lru_cache(maxsize=8)
def tile_permutation(width: int, height: int, tile_w: int,
                     tile_h: int = TILE_H) -> np.ndarray:
    """tidx[j] = row-major pixel index of the j-th pixel in tile order."""
    lin = np.arange(width * height, dtype=np.int32).reshape(height, width)
    x = lin.reshape(height // tile_h, tile_h, width // tile_w, tile_w)
    return np.swapaxes(x, 1, 2).reshape(-1)


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


def view_depth_to_world_pos(view: PlanarViewConstants, pixel_x, pixel_y,
                            view_depth: torch.Tensor) -> torch.Tensor:
    """Port of viewDepthToWorldPos (GBufferHelpers.glsl:54-67)."""
    rays = setup_primary_ray(pixel_x, pixel_y, view)
    return rays.origin + rays.direction * view_depth[..., None]


def get_motion_vector(view: PlanarViewConstants,
                      view_prev: PlanarViewConstants,
                      world_pos: torch.Tensor,
                      prev_world_pos: torch.Tensor) -> torch.Tensor:
    """Port of getMotionVector (GBufferHelpers.glsl:29-52): pixel-space xy
    delta to the previous frame + clip-w depth delta."""
    dev = world_pos.device
    ones = torch.ones(world_pos.shape[:-1] + (1,), dtype=world_pos.dtype,
                      device=dev)
    clip = matvec(view_tensor(view.mat_world_to_clip, dev),
                  torch.cat([world_pos, ones], dim=-1))
    prev_clip = matvec(view_tensor(view_prev.mat_world_to_clip, dev),
                       torch.cat([prev_world_pos, ones], dim=-1))
    w = clip[..., 3:4]
    pw = prev_clip[..., 3:4]
    ndc = clip[..., :3] / torch.where(w == 0.0, 1.0, w)
    prev_ndc = prev_clip[..., :3] / torch.where(pw == 0.0, 1.0, pw)

    motion_xy = ((prev_ndc[..., :2] - ndc[..., :2]) / 2.0
                 * view_tensor(view.viewport_size, dev)
                 + (view_tensor(view.pixel_offset, dev)
                    - view_tensor(view_prev.pixel_offset, dev)))
    motion_z = (prev_clip[..., 3] - clip[..., 3])[..., None]
    motion = torch.cat([motion_xy, motion_z], dim=-1)
    valid = (clip[..., 3:4] > 0.0) & (prev_clip[..., 3:4] > 0.0)
    return torch.where(valid, motion, 0.0)


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


def convert_motion_vector_to_pixel_space(
        view: PlanarViewConstants, view_prev: PlanarViewConstants,
        pixel_x: torch.Tensor, pixel_y: torch.Tensor,
        motion: torch.Tensor) -> torch.Tensor:
    """Port of convertMotionVectorToPixelSpace (GBufferHelpers.glsl:69-80)."""
    dev = motion.device
    center = torch.stack([pixel_x.to(torch.float32) + 0.5,
                          pixel_y.to(torch.float32) + 0.5], dim=-1)
    prev_pos = center + motion[..., :2]
    prev_pos = prev_pos * (view_tensor(view_prev.viewport_size, dev)
                           * view_tensor(view.viewport_size_inv, dev))
    return torch.cat([prev_pos - center, motion[..., 2:]], dim=-1)
