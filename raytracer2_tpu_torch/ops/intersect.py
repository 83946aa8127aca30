"""Hit records, the slab-safe reciprocal direction and the brute-force
closest-hit and any-hit oracles, port of raytracer2_tpu/ops/intersect.py.

The traversal result is the reference's payload (common.glsl:23-28):
{t, barycentric uv, geometryIndex, primitiveId} with geometryIndex ==
INVALID_INDEX on a miss, no backface culling. uint32 ids are carried in
int64 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.utils.brdf import cross, dot3

INVALID_INDEX = 0xFFFFFFFF


class HitRecord(NamedTuple):
    """Traversal result, SoA over rays (ref payload: common.glsl:23-28)."""

    t: torch.Tensor  # [...] hit distance; t_max on miss
    u: torch.Tensor  # [...] barycentric u
    v: torch.Tensor  # [...] barycentric v
    geometry_index: torch.Tensor  # [...] int64; INVALID_INDEX on miss
    primitive_id: torch.Tensor  # [...] int64
    triangle_index: torch.Tensor  # [...] int32 global tri id; -1 on miss

    @property
    def missed(self) -> torch.Tensor:
        return self.geometry_index == INVALID_INDEX


def moller_trumbore(origin, direction, v0, edge1, edge2, t_min, t_max,
                    eps: float = 1e-9):
    """Vectorized Möller-Trumbore; returns (hit_mask, t, u, v). Double-sided;
    all inputs broadcast elementwise."""
    pvec = cross(direction, edge2)
    det = dot3(edge1, pvec)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / det, 0.0)

    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot3(direction, qvec) * inv_det
    t = dot3(edge2, qvec) * inv_det

    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v


def ray_aabb(origin: torch.Tensor, inv_direction: torch.Tensor,
             box_min: torch.Tensor, box_max: torch.Tensor, t_min, t_max
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The slab test of rays ([..., 3] origins and precomputed 1/d, e.g.
    safe_inv_dir) against boxes ([..., 3] corners): (hit mask, entry t
    clamped up to t_min). The min/max order keeps axis-parallel rays
    robust."""
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max)
    return hit, torch.maximum(t_near, torch.as_tensor(t_min,
                                                      dtype=t_near.dtype,
                                                      device=t_near.device))


def safe_inv_dir(direction: torch.Tensor, eps: float = 1e-12
                 ) -> torch.Tensor:
    """1/d with tiny-component clamping so slab tests stay finite-robust."""
    d = torch.where(torch.abs(direction) < eps,
                    torch.where(direction >= 0.0, eps, -eps), direction)
    return 1.0 / d


def _per_ray(x, n, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=ref.device).expand(n).contiguous()


def intersect_brute_force(origins, directions, tri_v0, tri_edge1, tri_edge2,
                          tri_geometry, tri_primitive, t_min, t_max,
                          chunk: int = 512) -> HitRecord:
    """Closest hit over every triangle; the BVH-free correctness oracle.
    Scans triangle chunks of `chunk` to bound the [N, chunk] footprint; a
    later chunk wins only with a strictly smaller t, and inside a chunk the
    lowest index wins a tie, as in the JAX version."""
    n = origins.shape[0]
    t_cap = _per_ray(t_max, n, origins)
    t_lo = _per_ray(t_min, n, origins)
    best_t = t_cap.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=origins.device)
    rows = torch.arange(n, device=origins.device)
    o = origins[:, None, :]
    d = directions[:, None, :]
    for start in range(0, tri_v0.shape[0], chunk):
        stop = min(start + chunk, tri_v0.shape[0])
        hit, t, u, v = moller_trumbore(
            o, d, tri_v0[None, start:stop], tri_edge1[None, start:stop],
            tri_edge2[None, start:stop], t_lo[:, None], best_t[:, None])
        t = torch.where(hit, t, torch.inf)
        arg = torch.argmin(t, dim=-1)
        t_c = t[rows, arg]
        better = t_c < best_t
        best_t = torch.where(better, t_c, best_t)
        best_u = torch.where(better, u[rows, arg], best_u)
        best_v = torch.where(better, v[rows, arg], best_v)
        best_tri = torch.where(better, (arg + start).to(torch.int32),
                               best_tri)

    missed = best_tri < 0
    safe = torch.clamp_min(best_tri, 0).long()
    geom = torch.where(missed, INVALID_INDEX, tri_geometry[safe].long())
    prim = torch.where(missed, 0, tri_primitive[safe].long())
    return HitRecord(
        t=torch.where(missed, t_cap, best_t), u=best_u, v=best_v,
        geometry_index=geom, primitive_id=prim, triangle_index=best_tri)


def occluded_brute_force(origins, directions, tri_v0, tri_edge1, tri_edge2,
                         t_min, t_max, chunk: int = 512) -> torch.Tensor:
    """Any-hit visibility query over every triangle: True where a triangle
    blocks the open segment (t_min, t_max)."""
    n = origins.shape[0]
    t_hi = _per_ray(t_max, n, origins)[:, None]
    t_lo = _per_ray(t_min, n, origins)[:, None]
    blocked = torch.zeros(n, dtype=torch.bool, device=origins.device)
    o = origins[:, None, :]
    d = directions[:, None, :]
    for start in range(0, tri_v0.shape[0], chunk):
        stop = min(start + chunk, tri_v0.shape[0])
        hit, _, _, _ = moller_trumbore(
            o, d, tri_v0[None, start:stop], tri_edge1[None, start:stop],
            tri_edge2[None, start:stop], t_lo, t_hi)
        blocked |= hit.any(dim=-1)
    return blocked
