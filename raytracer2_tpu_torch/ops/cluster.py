"""Triangle clusters + unit-triangle-space (Wald) transforms, port of the
part of raytracer2_tpu/ops/cluster.py the closest-hit walk needs.

Triangles are grouped into fixed-size clusters with AABBs (by the native
binned-SAH builder, ops/native.py, or a Morton fallback) and each triangle
gets the affine map W = [A | b] that carries world space into its unit
space. For a ray (o, d):

    o' = A @ o + b        d' = A @ d
    t  = -o'_z / d'_z     u = o'_x + t * d'_x     v = o'_y + t * d'_y

The build is the JAX package's numpy code, so both produce the same
triangle order, boxes and transforms bit for bit. The per-bundle interval
cull (bundle_cluster_overlap) feeds the pixel-tile candidate prep.
intersect_cluster_block is the JAX engines' all-pairs test; the port's
engines test their hits with wald.hit_test, which rounds the same way on
the lanes that can hit, and the scatter engine re-evaluates its winners
with intersect_cluster_block.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from raytracer2_tpu_torch.ops.wald import fma


class Clusters(NamedTuple):
    """Triangle clusters, SoA; num_triangles == num_clusters * cluster_size
    after degenerate padding."""

    aabb_min: torch.Tensor  # [C, 3]
    aabb_max: torch.Tensor  # [C, 3]
    wald: torch.Tensor  # [C, 4, 3*S]: the [A|b]^T blocks
    tri_index: torch.Tensor  # [C, S] int32 original triangle id (-1 = pad)

    @property
    def num_clusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_index.shape[1]


def clusters_from_arrays(arrays: Mapping, *, device) -> Clusters:
    """Clusters from numpy arrays keyed by field name."""
    return Clusters(**{
        f: torch.from_numpy(np.array(arrays[f])).to(device)
        for f in Clusters._fields})


def _wald_matrices(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray
                   ) -> np.ndarray:
    """[T, 3, 4] affine world->unit-triangle maps (rows: u, v, z planes)."""
    t = v0.shape[0]
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)  # [T, 3, 3] columns = basis
    # robust inverse: degenerate triangles get zero maps (never hit)
    det = np.linalg.det(m)
    good = np.abs(det) > 1e-20
    m_safe = np.where(good[:, None, None], m, np.eye(3)[None])
    inv = np.linalg.inv(m_safe)
    inv = np.where(good[:, None, None], inv, 0.0)
    b = -np.einsum("tij,tj->ti", inv, v0)
    out = np.zeros((t, 3, 4), np.float32)
    out[:, :, :3] = inv
    out[:, :, 3] = b
    return out


def _morton_order(centroid: np.ndarray) -> np.ndarray:
    lo = centroid.min(0)
    extent = np.maximum(centroid.max(0) - lo, 1e-12)
    cells = np.clip(((centroid - lo) / extent) * 1024.0, 0,
                    1023.999).astype(np.uint32)

    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        v = (v | (v << 1)) & 0x5555555555555555
        return v

    codes = (expand(cells[:, 0]) << 2) | (expand(cells[:, 1]) << 1) \
        | expand(cells[:, 2])
    return np.argsort(codes, kind="stable").astype(np.int32)


CLUSTER_METHODS = ("auto", "sah", "morton")


def cluster_arrays(tri_v0, tri_edge1, tri_edge2, cluster_size: int = 64,
                   method: str = "auto") -> dict:
    """The host build as numpy arrays. method (JAX's): "sah" the native
    binned-SAH builder (raises where its library does not load), "morton"
    a Morton order in numpy, "auto" SAH when the library loads, else
    Morton (ops.native.available() says which ran)."""
    if method not in CLUSTER_METHODS:
        raise ValueError(f"method must be one of {CLUSTER_METHODS}, "
                         f"not {method!r}")
    v0 = np.asarray(tri_v0, np.float64)
    e1 = np.asarray(tri_edge1, np.float64)
    e2 = np.asarray(tri_edge2, np.float64)
    t = v0.shape[0]

    v1 = v0 + e1
    v2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    ranges = None
    if method != "morton" and t > 0:
        from raytracer2_tpu_torch.ops import native

        sah = native.build_sah_clusters(
            v0.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32), cluster_size)
        if sah is not None:
            order, offsets, counts = sah
            ranges = list(zip(offsets.tolist(), counts.tolist()))
        elif method == "sah":
            raise RuntimeError("native SAH builder unavailable")
    if ranges is None:
        order = _morton_order(centroid) if t else np.zeros(0, np.int32)
        ranges = [(i, min(cluster_size, t - i))
                  for i in range(0, t, cluster_size)]

    c = max(len(ranges), 1)
    n_padded = c * cluster_size

    # scatter the ordered triangles into fixed-stride cluster rows
    tri_index = np.full(n_padded, -1, np.int32)
    src = np.zeros(n_padded, np.int64)  # index into `order`
    valid = np.zeros(n_padded, bool)
    for ci, (start, count) in enumerate(ranges):
        row = ci * cluster_size
        tri_index[row:row + count] = order[start:start + count]
        src[row:row + count] = np.arange(start, start + count)
        valid[row:row + count] = True

    def take(arr, fill):
        out = np.full((n_padded, 3), fill, np.float64)
        out[valid] = arr[order[src[valid]]]
        return out

    sv0 = take(v0, 0.0)
    se1 = take(e1, 0.0)
    se2 = take(e2, 0.0)
    stmin = take(tmin, np.inf)
    stmax = take(tmax, -np.inf)

    aabb_min = stmin.reshape(c, cluster_size, 3).min(1)
    aabb_max = stmax.reshape(c, cluster_size, 3).max(1)
    # empty (all-pad) clusters get never-hit boxes
    aabb_min = np.where(np.isfinite(aabb_min), aabb_min, 1e30)
    aabb_max = np.where(np.isfinite(aabb_max), aabb_max, -1e30)

    wald = _wald_matrices(sv0, se1, se2)  # [n_padded, 3, 4]
    # per cluster, one [4, 3S] block whose columns are the (u, v, z) rows
    # of each triangle
    wald = (wald.reshape(c, cluster_size, 3, 4)
            .transpose(0, 3, 1, 2)  # [C, 4, S, 3]
            .reshape(c, 4, cluster_size * 3))

    return dict(aabb_min=aabb_min.astype(np.float32),
                aabb_max=aabb_max.astype(np.float32),
                wald=wald.astype(np.float32),
                tri_index=tri_index.reshape(c, cluster_size))


def build_clusters(tri_v0, tri_edge1, tri_edge2, cluster_size: int = 64,
                   method: str = "auto", *, device) -> Clusters:
    """Host-side build (numpy/C++; scenes are static like the reference's
    one-time BLAS build) onto `device`; method as cluster_arrays'."""
    return clusters_from_arrays(
        cluster_arrays(tri_v0, tri_edge1, tri_edge2, cluster_size, method),
        device=device)


def intersect_cluster_block(origins, directions, wald_block, t_min, t_cap):
    """All-pairs intersection of R rays with one cluster block: origins,
    directions [..., R, 3], wald_block [..., 4, 3S] (the [A|b]^T block of
    Clusters.wald), t_min, t_cap [..., R]; leading dimensions broadcast, as
    JAX's vmap of it. Returns (hit [..., R, S], t, u, v) with hit = |d'_z|
    > 1e-12, u >= 0, v >= 0, u + v <= 1, t_min < t < t_cap.

    Rounded as XLA's CPU backend rounds the JAX function (read off the
    jitted function's outputs): each affine x wx + y wy + z wz [+ bias] is
    fma(z, wz, fma(x, wx, y * wy)) [+ bias], t = -o'_z / d'_z (d'_z = 1
    where |d'_z| <= 1e-12) and u, v are fma(t, d', o'); so t, u and v equal
    the JAX package's bit for bit on every lane. The fused multiply-adds
    are wald.fma (float64 work): the engines test their hits with the
    float32 pass of wald.hit_test instead, which rounds the same way on
    the lanes that can hit."""
    w = wald_block[..., None, :, :]  # [..., 1, 4, 3S]

    def affine(x, bias):
        acc = fma(x[..., 2:3], w[..., 2, :], fma(
            x[..., 0:1], w[..., 0, :], x[..., 1:2] * w[..., 1, :]))
        return acc + w[..., 3, :] if bias else acc

    op = affine(origins, True)
    dp = affine(directions, False)
    op = op.reshape(*op.shape[:-1], -1, 3)
    dp = dp.reshape(*dp.shape[:-1], -1, 3)
    dz = dp[..., 2]
    valid = torch.abs(dz) > 1e-12
    t = -op[..., 2] / torch.where(valid, dz, 1.0)
    u = fma(t, dp[..., 0], op[..., 0])
    v = fma(t, dp[..., 1], op[..., 1])
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[..., None]) & (t < t_cap[..., None]))
    return hit, t, u, v


def bundle_cluster_overlap(o_min, o_max, inv_lo, inv_hi, t_max,
                           box_min, box_max
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conservative bundle-vs-cluster slab test with interval arithmetic;
    never reports a false miss. Bundle inputs are [B, 3] ([B] for t_max),
    boxes [C, 3]. Returns (may_hit [B, C], t_enter_lo [B, C])."""

    def interval_mul(a_lo, a_hi, b_lo, b_hi):
        p1 = a_lo * b_lo
        p2 = a_lo * b_hi
        p3 = a_hi * b_lo
        p4 = a_hi * b_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    # plane distances as intervals: (box - o) with o in [o_min, o_max]
    bm = box_min[None, :, :]
    bx = box_max[None, :, :]
    d0_lo = bm - o_max[:, None, :]
    d0_hi = bm - o_min[:, None, :]
    d1_lo = bx - o_max[:, None, :]
    d1_hi = bx - o_min[:, None, :]

    il = inv_lo[:, None, :]
    ih = inv_hi[:, None, :]
    t0_lo, t0_hi = interval_mul(d0_lo, d0_hi, il, ih)
    t1_lo, t1_hi = interval_mul(d1_lo, d1_hi, il, ih)

    near_lo = torch.minimum(t0_lo, t1_lo)  # lower bound of per-axis t_near
    far_hi = torch.maximum(t0_hi, t1_hi)  # upper bound of per-axis t_far

    # axes whose direction interval spans zero are unbounded
    unbounded = ~torch.isfinite(il) | ~torch.isfinite(ih)
    near_lo = torch.where(unbounded, -torch.inf, near_lo)
    far_hi = torch.where(unbounded, torch.inf, far_hi)

    t_enter_lo = near_lo.amax(dim=-1)
    t_exit_hi = far_hi.amin(dim=-1)
    may_hit = ((t_enter_lo <= t_exit_hi)
               & (t_exit_hi >= 0.0)
               & (t_enter_lo <= t_max[:, None]))
    return may_hit, t_enter_lo
