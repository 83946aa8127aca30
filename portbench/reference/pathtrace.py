"""The reference mode's radiance at given pixels (refrence.rgen): per
pixel, `samples` diffuse paths of up to `bounces` hits from the camera
ray; a path adds the emission of every surface it hits (either face),
times the product of the albedos before it, and ends where it escapes
(the sky is black without an environment map). Each bounce draws three
uniforms of the pixel's sampler (seeded with frame + 13), the second and
third giving a cosine-weighted direction about the shading normal; only
the paths still alive draw. t_min is 0.001, t_max 100000."""

from __future__ import annotations

import torch

from portbench.reference import camera, rng, surface
from portbench.reference.glb import RefScene
from portbench.reference.intersect import closest_hit

T_MIN, T_MAX = 0.001, 100000.0


def _onb_to_world(n: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Helpers.glsl:112-119's branchless basis, bridge:118-128's order."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bitangent = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return bitangent * h[:, 0:1] + tangent * h[:, 1:2] + n * h[:, 2:3]


def _cosine_dir(n: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor):
    angle = 2.0 * torch.pi * r1
    r = torch.sqrt(r2)
    h = torch.stack([torch.cos(angle) * r, torch.sin(angle) * r,
                     torch.sqrt(torch.clamp(1.0 - r2, 0.0, 1.0))], -1)
    return _onb_to_world(n, h)


def radiance(scene: RefScene, px: torch.Tensor, py: torch.Tensor, pose,
             width: int, height: int, frame_index: int, samples: int = 12,
             bounces: int = 5, dtype=torch.float32) -> torch.Tensor:
    """[n, 3] float32 mean radiance of the pixels' paths."""
    n = px.shape[0]
    dev = px.device
    s = rng.seed(px, py, frame_index + 13)
    index = torch.ones_like(s)
    o0, d0 = camera.primary_rays(px, py, pose["position"], pose["direction"],
                                 width, height, dtype)
    tn = torch.full((n,), T_MIN, device=dev)
    tx = torch.full((n,), T_MAX, device=dev)
    hit0 = closest_hit(scene, o0, d0, tn, tx, dtype)
    total = torch.zeros((n, 3), dtype=dtype, device=dev)
    for _ in range(samples):
        through = torch.ones((n, 3), dtype=dtype, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        o, d = o0, d0
        for bounce in range(bounces):
            if bounce == 0:
                t, tri, u, v = hit0
            else:
                t, tri, u, v = closest_hit(scene, o, d, tn,
                                           torch.where(alive, tx, -1.0),
                                           dtype)
            take = alive & (tri >= 0)
            surf = surface.at_hit(scene, tri, u, v, dtype)
            total = total + torch.where(take[:, None],
                                        through * surf.emission, 0.0)
            through = torch.where(take[:, None], through * surf.albedo,
                                  through)
            r1 = rng.uniform(s, index + 1).to(dtype)
            r2 = rng.uniform(s, index + 2).to(dtype)
            index = torch.where(take, index + 3, index)
            nd = _cosine_dir(surf.normal, r1, r2)
            pos = o + d * t.to(dtype)[:, None]
            o = torch.where(take[:, None], pos, o)
            d = torch.where(take[:, None], nd, d)
            alive = take
    return (total / samples).float()
