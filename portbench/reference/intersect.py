"""Brute-force ray queries over every triangle of a RefScene: Moller-
Trumbore, double-sided, a hit where t_min < t < t_max, in blocks of rays
and triangles so that the [rays, triangles] temporaries stay small."""

from __future__ import annotations

import torch

from portbench.reference.glb import RefScene


def _blocks(device, triangles: int) -> tuple[int, int]:
    """(rays, triangles) a block: about 2^24 (the CPU 2^18) ray-triangle
    pairs, at least 256 (64) rays."""
    cuda = device.type == "cuda"
    tb = (1 << 16) if cuda else (1 << 12)
    pairs, least = ((1 << 24), 256) if cuda else ((1 << 18), 64)
    return max(least, pairs // max(min(triangles, tb), 1)), tb


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _test(o, d, tn, tx, v0, e1, e2):
    """[r, t] hit mask, t, u, v of rays [r, 3] against triangles [t, 3]."""
    d_ = d[:, None, :]
    pvec = _cross(d_, e2[None])
    det = _dot(e1[None], pvec)
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o[:, None, :] - v0[None]
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1[None])
    v = _dot(d_, qvec) * inv
    t = _dot(e2[None], qvec) * inv
    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1)
           & (t > tn[:, None]) & (t < tx[:, None]))
    return hit, t, u, v


def _cast(scene: RefScene, dtype):
    return (scene.v0.to(dtype), scene.e1.to(dtype), scene.e2.to(dtype))


def closest_hit(scene: RefScene, o, d, t_min, t_max, dtype=torch.float32):
    """(t, triangle, u, v) per ray as float32/int64: t = +inf and triangle
    -1 where the ray hits nothing."""
    v0, e1, e2 = _cast(scene, dtype)
    rb, tb = _blocks(o.device, scene.num_triangles)
    n = o.shape[0]
    best_t = torch.full((n,), float("inf"), device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros(n, device=o.device)
    best_v = torch.zeros(n, device=o.device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=o.device)
    for r0 in range(0, n, rb):
        rs = slice(r0, r0 + rb)
        ro, rd = o[rs].to(dtype), d[rs].to(dtype)
        rn, rx = t_min[rs].to(dtype), t_max[rs].to(dtype)
        for t0 in range(0, scene.num_triangles, tb):
            ts = slice(t0, t0 + tb)
            hit, t, u, v = _test(ro, rd, rn, rx, v0[ts], e1[ts], e2[ts])
            tm, arg = torch.where(hit, t, inf).min(dim=1)
            tm = tm.float()
            better = tm < best_t[rs]
            pick = arg[:, None]
            best_t[rs] = torch.where(better, tm, best_t[rs])
            best_i[rs] = torch.where(better, arg + t0, best_i[rs])
            best_u[rs] = torch.where(better, u.gather(1, pick)[:, 0].float(),
                                     best_u[rs])
            best_v[rs] = torch.where(better, v.gather(1, pick)[:, 0].float(),
                                     best_v[rs])
    return best_t, best_i, best_u, best_v


def any_hit(scene: RefScene, o, d, t_min, t_max, dtype=torch.float32):
    """[n] bool: the segment (t_min, t_max) of each ray meets a triangle."""
    v0, e1, e2 = _cast(scene, dtype)
    rb, tb = _blocks(o.device, scene.num_triangles)
    n = o.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=o.device)
    for r0 in range(0, n, rb):
        rs = slice(r0, r0 + rb)
        ro, rd = o[rs].to(dtype), d[rs].to(dtype)
        rn, rx = t_min[rs].to(dtype), t_max[rs].to(dtype)
        for t0 in range(0, scene.num_triangles, tb):
            ts = slice(t0, t0 + tb)
            hit = _test(ro, rd, rn, rx, v0[ts], e1[ts], e2[ts])[0]
            out[rs] |= hit.any(dim=1)
    return out
