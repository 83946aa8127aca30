"""Functional FPS camera producing PlanarViewConstants, port of
raytracer2_tpu/scene/camera.py (plain numpy, ported only because the
original imports JAX through params.py).

Port of the reference camera (src/camera.rs): right-handed look-at view with
UP = (0, -1, 0) (camera.rs:14), a custom perspective projection
(camera.rs:146-157), and the PlanarViewConstants assembly (camera.rs:111-142).

Matrices are [4,4] float32 with the mathematical convention `M @ v` (glam's
Mat4 * Vec4); all matrix products therefore map directly to `a @ b`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from raytracer2_tpu_torch.params import PlanarViewConstants

MOVE_SPEED = 30.0  # (ref: camera.rs:11)
ANGLE_PER_POINT = 1.0  # (ref: camera.rs:12)
UP = np.array([0.0, -1.0, 0.0], dtype=np.float32)  # (ref: camera.rs:14)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def look_at_rh(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed look-at view matrix (glam Mat4::look_at_rh semantics,
    used at camera.rs:99-101)."""
    f = _normalize(center - eye)
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """The reference's custom projection (camera.rs:146-157). Note clip.w = +z
    and the depth mapping -(n+f)z - 2nf*z_scale; replicated exactly.

    QUIRK: because look_at_rh maps the camera's forward axis to view-space -z
    while this projection sets clip.w = +z_view, primary rays generated by
    setupPrimaryRay point OPPOSITE to Camera.direction — the reference's
    startup camera at (0,0,10) with direction (0,0,1) (main.rs:114-121)
    actually looks at the origin. Preserved for parity."""
    y_scale = 1.0 / np.tan(0.5 * fovy)
    x_scale = y_scale / aspect
    z_scale = 1.0 / (far - near)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = -(near + far) * z_scale
    m[2, 3] = -2.0 * near * far * z_scale
    m[3, 2] = 1.0
    return m


@dataclasses.dataclass(frozen=True)
class Controls:
    """Per-frame input snapshot (ref: camera.rs:160-183)."""

    go_forward: bool = False
    go_backward: bool = False
    strafe_right: bool = False
    strafe_left: bool = False
    go_up: bool = False
    go_down: bool = False
    look_around: bool = False
    cursor_delta: tuple[float, float] = (0.0, 0.0)


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation matrix around a unit axis (Rodrigues)."""
    axis = _normalize(axis)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = axis
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=np.float64)
    return (np.eye(3) + s * k + (1 - c) * (k @ k)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole FPS camera (ref: camera.rs:16-43)."""

    position: tuple[float, float, float]
    direction: tuple[float, float, float]
    fov: float  # vertical, degrees (to_radians applied in projection)
    aspect_ratio: float
    z_near: float
    z_far: float
    window_size: tuple[int, int] = (1920, 1080)

    def __post_init__(self):
        d = _normalize(np.asarray(self.direction, dtype=np.float32))
        object.__setattr__(self, "direction", tuple(float(x) for x in d))

    def update(self, controls: Controls, delta_time: float) -> "Camera":
        """Functional port of camera.rs:45-97."""
        pos = np.asarray(self.position, dtype=np.float32)
        direction = np.asarray(self.direction, dtype=np.float32)
        side = np.cross(direction, UP)

        if controls.look_around:
            side_rot = _axis_angle_matrix(
                side, -controls.cursor_delta[1] * ANGLE_PER_POINT * delta_time)
            y_rot = _axis_angle_matrix(
                np.array([0.0, 1.0, 0.0], dtype=np.float32),
                -controls.cursor_delta[0] * ANGLE_PER_POINT * delta_time)
            new_direction = _normalize(side_rot @ y_rot @ direction)
        else:
            new_direction = direction

        move = np.zeros(3, dtype=np.float32)
        if controls.go_forward:
            move -= new_direction
        if controls.go_backward:
            move += new_direction
        if controls.strafe_right:
            move += side
        if controls.strafe_left:
            move -= side
        if controls.go_up:
            move -= UP
        if controls.go_down:
            move += UP
        if np.dot(move, move) > 0.0:
            move = _normalize(move)

        return dataclasses.replace(
            self,
            position=tuple(float(x) for x in pos + move * MOVE_SPEED * delta_time),
            direction=tuple(float(x) for x in new_direction),
        )

    def view_matrix(self) -> np.ndarray:
        pos = np.asarray(self.position, dtype=np.float32)
        return look_at_rh(pos, pos + np.asarray(self.direction, np.float32), UP)

    def projection_matrix(self) -> np.ndarray:
        return perspective(
            np.deg2rad(self.fov), self.aspect_ratio, self.z_near, self.z_far)

    def planar_view_constants(self) -> PlanarViewConstants:
        """Port of camera.rs:111-142. Returns numpy arrays; each pass moves
        what it reads to its device."""
        w, h = self.window_size
        window_size = np.array([w, h], dtype=np.float32)
        clip_to_window_scale = np.array([0.5 * w, -0.5 * h], dtype=np.float32)
        clip_to_window_bias = window_size * 0.5
        window_to_clip_scale = 1.0 / clip_to_window_scale

        view = self.view_matrix()
        proj = self.projection_matrix()
        view_inv = np.linalg.inv(view.astype(np.float64)).astype(np.float32)
        proj_inv = np.linalg.inv(proj.astype(np.float64)).astype(np.float32)

        return PlanarViewConstants(
            mat_world_to_view=view,
            mat_view_to_clip=proj,
            mat_world_to_clip=(proj.astype(np.float64)
                               @ view.astype(np.float64)).astype(np.float32),
            mat_clip_to_view=proj_inv,
            mat_view_to_world=view_inv,
            mat_clip_to_world=(view_inv.astype(np.float64)
                               @ proj_inv.astype(np.float64)).astype(np.float32),
            viewport_origin=np.zeros(2, dtype=np.float32),
            viewport_size=window_size,
            viewport_size_inv=(1.0 / window_size).astype(np.float32),
            pixel_offset=np.zeros(2, dtype=np.float32),
            clip_to_window_scale=clip_to_window_scale,
            clip_to_window_bias=clip_to_window_bias,
            window_to_clip_scale=window_to_clip_scale,
            window_to_clip_bias=(-clip_to_window_bias
                                 * window_to_clip_scale).astype(np.float32),
            camera_direction_or_position=np.array(
                [*self.position, 1.0], dtype=np.float32),
        )


def default_camera(window_size: tuple[int, int] = (1920, 1080),
                   position: Sequence[float] = (0.0, 0.0, 10.0),
                   direction: Sequence[float] = (0.0, 0.0, 1.0),
                   fov: float = 65.0, z_near: float = 0.1,
                   z_far: float = 1000.0) -> Camera:
    """Startup camera matching main.rs:114-121."""
    w, h = window_size
    return Camera(
        position=tuple(position), direction=tuple(direction), fov=fov,
        aspect_ratio=w / h, z_near=z_near, z_far=z_far, window_size=window_size)
