"""The surface at a hit (Hit.glsl:2-70): the interpolated vertex normal
turned by the node matrix (no inverse transpose, as the renderer does),
base colour times vertex colour times the bilinear, repeat-wrapped
base-colour texel, specular F0 = colour x metallic, roughness 1 and the
emission x 12."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.glb import ROUGHNESS, RefScene


class Surface(NamedTuple):
    normal: torch.Tensor  # [n, 3]
    albedo: torch.Tensor  # [n, 3]
    specular_f0: torch.Tensor  # [n, 3]
    roughness: torch.Tensor  # [n]
    emission: torch.Tensor  # [n, 3]


def _unit(v):
    return v / torch.clamp_min(torch.sqrt((v * v).sum(-1)), 1e-20)[..., None]


def _bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = tex.shape[0], tex.shape[1]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()
    x0i, x1i = torch.remainder(xi, w), torch.remainder(xi + 1, w)
    y0i, y1i = torch.remainder(yi, h), torch.remainder(yi + 1, h)
    t = tex.to(uv.dtype)
    c00, c10 = t[y0i, x0i], t[y0i, x1i]
    c01, c11 = t[y1i, x0i], t[y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def at_hit(scene: RefScene, tri: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor, dtype=torch.float32) -> Surface:
    """The surface of each hit (tri >= 0; other rows are junk)."""
    i = torch.clamp_min(tri, 0)
    b = torch.stack([1.0 - u - v, u, v], -1).to(dtype)[..., None]  # [n,3,1]
    n = _unit((scene.normals[i].to(dtype) * b).sum(1))
    xf = scene.xform[i].to(dtype)
    n = _unit((xf * n[:, None, :]).sum(-1))
    uv = (scene.uvs[i].to(dtype) * b).sum(1)
    color = scene.base_color[i].to(dtype) * (scene.colors[i].to(dtype)
                                             * b).sum(1)
    ti = scene.texture[i]
    for k, tex in enumerate(scene.textures):
        on = ti == k
        if bool(on.any()):
            texel = _bilinear(tex, uv[on])[:, :3]
            color[on] = color[on] * texel
    met = scene.metallic[i].to(dtype)[:, None]
    return Surface(normal=n, albedo=color, specular_f0=color * met,
                   roughness=torch.full_like(u, ROUGHNESS, dtype=dtype),
                   emission=scene.emission[i].to(dtype))
