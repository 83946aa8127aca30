"""Composite + AgX tonemap pass, port of raytracer2_tpu/render/postprocess.py
(src/shaders/post_processing.comp): reference-mode passthrough,
albedo/specular remodulation + emissive add for the lit path, environment
radiance + env motion vectors for background pixels, then AgX (input
transform, log2 encode, sigmoid fit, look, inverse outset + 2.2 EOTF) and
the NaN->red debug canary (post_processing.comp:187-189).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.params import BACKGROUND_DEPTH, GConst
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.scene.scene import Scene, get_environment_radiance
from raytracer2_tpu_torch.utils.readback import constant

# GLSL mat3 constructor is column-major; `agx_mat * val` therefore applies
# the matrix whose ROWS are the listed triples (post_processing.comp:61-64)
_AGX_MAT = (
    (0.842479062253094, 0.0784335999999992, 0.0792237451477643),
    (0.0423282422610123, 0.878468636469772, 0.0791661274605434),
    (0.0423756549057051, 0.0784336, 0.879142973793104),
)
_AGX_MAT_INV = (
    (1.19687900512017, -0.0980208811401368, -0.0990297440797205),
    (-0.0528968517574562, 1.15190312990417, -0.0989611768448433),
    (-0.0529716355144438, -0.0980434501171241, 1.15107367264116),
)

_MIN_EV = -12.47393
_MAX_EV = 4.026069


def _apply(mat, val: torch.Tensor) -> torch.Tensor:
    m = constant(mat, val.device, torch.float32)
    return raysmod.matvec(m, val)


def agx_default_contrast_approx(x: torch.Tensor) -> torch.Tensor:
    """6th-order sigmoid fit (post_processing.comp:47-58)."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4
            - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(val: torch.Tensor) -> torch.Tensor:
    """AgX input transform + log2 encode + sigmoid (post_processing.comp:60-80)."""
    val = _apply(_AGX_MAT, val)
    val = torch.clamp(torch.log2(torch.clamp_min(val, 1e-10)),
                      _MIN_EV, _MAX_EV)
    val = (val - _MIN_EV) / (_MAX_EV - _MIN_EV)
    return agx_default_contrast_approx(val)


def agx_eotf(val: torch.Tensor) -> torch.Tensor:
    """Inverse outset + sRGB 2.2 linearization (post_processing.comp:82-97)."""
    val = _apply(_AGX_MAT_INV, val)
    return torch.pow(torch.clamp_min(val, 0.0), 2.2)


def agx_look(val: torch.Tensor, look: int = 0) -> torch.Tensor:
    """ASC CDL grade (post_processing.comp:99-124). look: 0 default,
    1 golden, 2 punchy (compile-time AGX_LOOK in the reference)."""
    def vec(x):
        return constant(tuple(x), val.device, val.dtype)

    luma = (val * vec([0.2126, 0.7152, 0.0722])).sum(dim=-1, keepdim=True)
    if look == 1:
        slope, power, sat = vec([1.0, 0.9, 0.5]), vec([0.8, 0.8, 0.8]), 0.8
    elif look == 2:
        slope, power, sat = vec([1.0, 1.0, 1.0]), vec([1.35] * 3), 1.4
    else:
        slope, power, sat = vec([1.0] * 3), vec([1.0] * 3), 1.0
    val = torch.pow(torch.clamp_min(val * slope, 0.0), power)
    return luma + sat * (val - luma)


def tonemap(col: torch.Tensor, look: int = 0) -> torch.Tensor:
    """Full AgX chain incl. the NaN->red canary (post_processing.comp:182-189)."""
    col = agx(col)
    col = agx_look(col, look)
    col = agx_eotf(col)
    col = torch.clamp_min(col, 0.000001)
    nan = torch.isnan(col).any(dim=-1, keepdim=True)
    red = constant((1.0, 0.0, 0.0), col.device, col.dtype).expand(col.shape)
    # the rgba8-unorm swapchain store clamps (post_processing.comp:190);
    # the AgX sigmoid fit can overshoot 1.0 by ~6e-4
    return torch.clamp(torch.where(nan, red, col), 0.0, 1.0)


class PostProcessInputs(NamedTuple):
    """Buffers the pass reads (post_processing.comp:9-19)."""

    depth: torch.Tensor  # [H, W]
    diffuse_albedo: torch.Tensor  # [H, W, 3] (unpacked R11G11B10)
    specular_f0: torch.Tensor  # [H, W, 3] (unpacked RGBA8-gamma rgb)
    emissive: torch.Tensor  # [H, W, 3]
    diffuse: torch.Tensor  # [H, W, 3] diffuse lighting
    specular: torch.Tensor  # [H, W, 3] specular lighting


def post_process(scene: Scene, g_const: GConst, inputs: PostProcessInputs,
                 row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Full pass (post_processing.comp:152-190). Returns (output [H,W,3] in
    [0,1], env_motion [H,W,2] for background pixels)."""
    h, w = inputs.depth.shape
    dev = inputs.depth.device

    if g_const.refrence_mode:
        col = inputs.diffuse
        env_motion = torch.zeros((h, w, 2), device=dev)
    else:
        px, py = raysmod.pixel_grid(w, h, device=dev)
        py = py + row0
        lit = inputs.diffuse
        spec = inputs.specular
        if g_const.textures:
            lit = lit * inputs.diffuse_albedo
            spec = spec * torch.clamp_min(inputs.specular_f0, 0.01)
        col_fg = lit + spec + inputs.emissive

        rays = raysmod.setup_primary_ray(px, py, g_const.view)
        col_bg = get_environment_radiance(scene, rays.direction,
                                          g_const.environment)
        window_pos = torch.stack([px.to(torch.float32) + 0.5,
                                  py.to(torch.float32) + 0.5], dim=-1)
        env_motion = raysmod.get_environment_motion_vector(
            g_const.view, g_const.prev_view, window_pos)

        is_fg = (inputs.depth != BACKGROUND_DEPTH)[..., None]
        col = torch.where(is_fg, col_fg, col_bg)
        env_motion = torch.where(is_fg, 0.0, env_motion)

    return tonemap(col), env_motion


def to_srgb_u8(img: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> u8 for display/PNG (the rgba8 swapchain store)."""
    return torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)
