"""Camera rays of the renderer's pinhole camera (src/camera.rs,
GBufferHelpers.glsl:12-27): a right-handed look-at view with up (0, -1,
0), the renderer's own perspective matrix (clip.w = +z, so primary rays
point opposite the camera's direction), fov 65 degrees, near 0.1, far
1000."""

from __future__ import annotations

import numpy as np
import torch

FOV_DEG, Z_NEAR, Z_FAR = 65.0, 0.1, 1000.0
UP = np.array([0.0, -1.0, 0.0], np.float32)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def view_inverses(position, direction, width: int, height: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(clip-to-view, view-to-world) as float32 [4, 4]."""
    eye = np.asarray(position, np.float32)
    f = _unit(_unit(np.asarray(direction, np.float32)))
    s = _unit(np.cross(f, UP))
    u = np.cross(s, f)
    view = np.eye(4, dtype=np.float32)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -s @ eye, -u @ eye, f @ eye
    y_scale = 1.0 / np.tan(0.5 * np.deg2rad(FOV_DEG))
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = y_scale / (width / height)
    proj[1, 1] = y_scale
    proj[2, 2] = -(Z_NEAR + Z_FAR) / (Z_FAR - Z_NEAR)
    proj[2, 3] = -2.0 * Z_NEAR * Z_FAR / (Z_FAR - Z_NEAR)
    proj[3, 2] = 1.0
    inv = (lambda m: np.linalg.inv(m.astype(np.float64)).astype(np.float32))
    return inv(proj), inv(view)


def _unit_t(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.sqrt((v * v).sum(-1)), 1e-20)[..., None]


def primary_rays(px: torch.Tensor, py: torch.Tensor, position, direction,
                 width: int, height: int, dtype=torch.float32
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions [n, 3] of the camera rays through pixel
    centres (px, py)."""
    clip_to_view, view_to_world = view_inverses(position, direction,
                                                width, height)
    dev = px.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)

    x = ((px.to(dtype) + 0.5) / width) * 2.0 - 1.0
    y = ((py.to(dtype) + 0.5) / height) * 2.0 - 1.0
    one = torch.ones_like(x)
    clip = torch.stack([x, y, one, one], -1)
    target = (t(clip_to_view) * clip[:, None, :]).sum(-1)
    tdir = _unit_t(target[:, :3])
    world = (t(view_to_world)[:3, :3] * tdir[:, None, :]).sum(-1)
    origin = t(position).expand(world.shape)
    return origin, world
