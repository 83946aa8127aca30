"""Scatter traversal, port of raytracer2_tpu/ops/traverse_scatter.py: per-ray
exact culling + ray binning over superclusters, as torch ops (backend
"scatter").

Every ray is culled exactly against supercluster boxes, its nearest
AVG_CANDIDATES overlapped superclusters become (ray, supercluster) pairs,
and the pairs are binned by supercluster into blocks of PAIR_BLOCK rays, so
each block tests P rays against one supercluster's triangles:

1. slab-test each ray against every supercluster ([n, C2], in chunks);
2. per ray the nearest K overlapped superclusters (ties to the lower
   index, as jax.lax.top_k), one stable sort of the n*K pair keys, then
   every padded pool slot pulls its (ray, supercluster) from the sorted
   list;
3. each block's rays against its supercluster's triangles (the JAX
   engine's cluster.intersect_cluster_block, here wald.hit_test), the
   nearest hit per pair;
4. a segment min of the pairs back onto rays (order-preserving float
   bits), then one re-evaluation of each ray's winning triangle for its
   exact (t, u, v) (cluster.intersect_cluster_block).

Capacity: a ray overlapping more than K superclusters drops its farthest
ones, and the pair pool may be exceeded; either sets `overflowed`, which
closest_hit_scatter and occluded_scatter return beside their result
(dropped pairs are reported, never hidden: the hits may then miss).

No Pallas kernel lies behind this engine, so it has no hand kernel. The
hits are tested with the float32 pass of wald.hit_test (exact fused
roundings where a hit could tip), and only the pool's blocks that
hold a pair are swept (the JAX sweep also sweeps the empty tail), which
changes no answer: hits, t, u and v equal the JAX engine's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer2_tpu_torch.ops import cull as cull_mod
from raytracer2_tpu_torch.ops.cluster import Clusters, intersect_cluster_block
from raytracer2_tpu_torch.ops.intersect import INVALID_INDEX, HitRecord
from raytracer2_tpu_torch.ops.traverse_bundle import _pad_rays, _per_ray
from raytracer2_tpu_torch.ops.wald import hit_test

PAIR_BLOCK = 128  # rays per work block
AVG_CANDIDATES = 16  # pair-pool size = rays * this
RAY_BATCH = 131072  # rays per dispatch slice
# (ray, triangle) lanes of one sweep chunk's test temporaries per device
SWEEP_LANES = {"cuda": 1 << 25, "cpu": 1 << 22}
INT32_MAX = 0x7FFFFFFF
NO_KEY = 0xFFFFFFFF


class SuperClusters(NamedTuple):
    """Clusters regrouped into G-cluster superclusters."""

    aabb_min: torch.Tensor  # [C2, 3]
    aabb_max: torch.Tensor  # [C2, 3]
    wald: torch.Tensor  # [C2, 4, G*3*S]
    tri_index: torch.Tensor  # [C2, G*S]
    tri_wald: torch.Tensor  # [T, 4, 3] per-triangle transform (final re-eval)

    @property
    def num_superclusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def tris_per_group(self) -> int:
        return self.tri_index.shape[1]


def build_superclusters(clusters: Clusters, group: int = 16
                        ) -> SuperClusters:
    """Regroup a Clusters structure into supercluster blocks (on the
    clusters' device)."""
    c = clusters.num_clusters
    s = clusters.cluster_size
    pad = (-c) % group
    pad_rows = (0, 0, 0, pad)
    amin = torch.nn.functional.pad(clusters.aabb_min, pad_rows, value=1e30)
    amax = torch.nn.functional.pad(clusters.aabb_max, pad_rows, value=-1e30)
    wald = torch.nn.functional.pad(clusters.wald, (0, 0, 0, 0, 0, pad))
    tri = torch.nn.functional.pad(clusters.tri_index, (0, 0, 0, pad),
                                  value=-1)
    c2 = (c + pad) // group

    sc_min = amin.reshape(c2, group, 3).amin(1)
    sc_max = amax.reshape(c2, group, 3).amax(1)
    sc_min = torch.where(sc_min > 1e29, 1e30, sc_min)
    sc_max = torch.where(sc_max < -1e29, -1e30, sc_max)
    sc_wald = (wald.reshape(c2, group, 4, 3 * s).permute(0, 2, 1, 3)
               .reshape(c2, 4, group * 3 * s))
    sc_tri = tri.reshape(c2, group * s)

    # per-triangle [4, 3] transforms for the final exact re-evaluation
    tri_wald = (wald.reshape(-1, 4, s, 3).permute(0, 2, 1, 3)
                .reshape(-1, 4, 3))
    flat_tri = tri.reshape(-1)
    n_tri = int(flat_tri.max()) + 1 if flat_tri.numel() else 0
    per_tri = torch.zeros((max(n_tri, 1), 4, 3), dtype=torch.float32,
                          device=wald.device)
    valid = flat_tri >= 0
    per_tri[flat_tri[valid].long()] = tri_wald[valid]
    return SuperClusters(aabb_min=sc_min.contiguous(),
                         aabb_max=sc_max.contiguous(),
                         wald=sc_wald.contiguous(),
                         tri_index=sc_tri.to(torch.int32).contiguous(),
                         tri_wald=per_tri)


def _f32_sortable_bits(t: torch.Tensor) -> torch.Tensor:
    """Monotonic uint32 encoding of non-negative floats (inf-safe), as an
    int64 holding the uint32."""
    return t.contiguous().view(torch.int32).long() & NO_KEY


def _ray_sc_overlap(origins, directions, t_min, t_max, sc: SuperClusters):
    """Exact per-ray slab test vs every supercluster: ([n, C2] mask, [n,
    C2] entry distance clamped at 0, +inf off the mask)."""
    eps = 1e-12
    d = torch.where(torch.abs(directions) < eps,
                    torch.where(directions >= 0, eps, -eps), directions)
    inv = 1.0 / d  # [n, 3]
    near = far = None
    for ax in range(3):
        t0 = (sc.aabb_min[None, :, ax] - origins[:, ax:ax + 1]) \
            * inv[:, ax:ax + 1]
        t1 = (sc.aabb_max[None, :, ax] - origins[:, ax:ax + 1]) \
            * inv[:, ax:ax + 1]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    mask = ((near <= far) & (far >= t_min[:, None])
            & (near <= t_max[:, None]) & (t_max >= 0.0)[:, None])
    entry = torch.where(mask, torch.clamp_min(near, 0.0), torch.inf)
    return mask, entry


def _candidates(origins, directions, t_min, t_max, sc: SuperClusters,
                k: int):
    """Per ray the nearest k overlapped superclusters [n, k] (a stable
    argsort: jax.lax.top_k's lower-index ties), whether each is live, and
    whether some ray overlaps more than k; in chunks of rays."""
    n, c2 = origins.shape[0], sc.num_superclusters
    chunk = max(1, cull_mod.chunk_bytes(origins.device) // (8 * 4 * c2))
    cand, live, over = [], [], []
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        mask, entry = _ray_sc_overlap(origins[sl], directions[sl], t_min[sl],
                                      t_max[sl], sc)
        idx = torch.argsort(entry, dim=-1, stable=True)[:, :k]
        cand.append(idx)
        live.append(torch.isfinite(torch.gather(entry, 1, idx)))
        over.append((mask.sum(dim=-1) > k).any())
    return torch.cat(cand), torch.cat(live), torch.stack(over).any()


def _sweep(origins, directions, t_min, t_max, sc: SuperClusters,
           pair_ray: torch.Tensor, block_sc: torch.Tensor):
    """Each block's rays (pair_ray [blocks, P], -1 for an empty slot)
    against its supercluster (block_sc [blocks]): per pair the nearest
    hit's t (+inf on none) and triangle (-1)."""
    nblk, p = pair_ray.shape
    gs = sc.tris_per_group
    s3 = sc.wald.shape[-1] // gs  # 3
    chunk = max(1, SWEEP_LANES[origins.device.type] // (p * gs))
    t_pair = torch.full((nblk, p), torch.inf, device=origins.device)
    tri_pair = torch.full((nblk, p), -1, dtype=torch.int32,
                          device=origins.device)
    for b0 in range(0, nblk, chunk):
        rays_c = pair_ray[b0:b0 + chunk]
        live = rays_c >= 0
        safe = torch.clamp_min(rays_c, 0)
        nb = rays_c.shape[0]
        r = torch.cat([origins[safe], directions[safe],
                       torch.where(live, t_min[safe], 0.0)[..., None],
                       torch.where(live, t_max[safe], -1.0)[..., None]],
                      dim=-1)  # [nb, P, 8]
        bsc = block_sc[b0:b0 + chunk].long()
        wr = (sc.wald[bsc].reshape(nb, 4, gs, s3).permute(0, 1, 3, 2)
              .reshape(nb, 12, 1, gs))
        tri_ids = sc.tri_index[bsc]  # [nb, G*S]
        t, hit = hit_test(r, wr)
        hit &= (t < r[..., 7:8]) & (tri_ids >= 0)[:, None, :]
        t_best, best = torch.where(hit, t, torch.inf).min(dim=-1)
        t_pair[b0:b0 + chunk] = t_best
        tri_pair[b0:b0 + chunk] = torch.where(
            torch.isfinite(t_best), torch.gather(tri_ids, 1, best), -1)
    return t_pair.reshape(-1), tri_pair.reshape(-1)


def _trace_scatter_batch(origins, directions, t_min, t_max,
                         sc: SuperClusters, avg_candidates: int,
                         any_hit: bool):
    """One ray batch through the scatter pipeline (JAX
    _trace_scatter_batch). Returns per ray (best_tri, missed, blocked,
    overflow): closest hit fills the first two, any hit the third."""
    n = origins.shape[0]
    dev = origins.device
    c2 = sc.num_superclusters
    p = PAIR_BLOCK
    k_cand = min(avg_candidates, c2)

    cand_sc, cand_live, overflow = _candidates(origins, directions, t_min,
                                               t_max, sc, k_cand)

    # sort the n*K pairs by supercluster id (dead pairs last)
    flat_sc = torch.where(cand_live, cand_sc, c2).reshape(-1)
    order = torch.argsort(flat_sc, stable=True)
    sorted_sc = flat_sc[order]
    sorted_ray = torch.div(order, k_cand, rounding_mode="floor")

    # per-supercluster counts -> padded slot layout
    count_sc = torch.bincount(torch.clamp_max(sorted_sc, c2),
                              minlength=c2 + 1)[:c2]
    base_sc = torch.cumsum(count_sc, 0) - count_sc
    padded_sc = (count_sc + p - 1) // p * p
    padded_cum = torch.cumsum(padded_sc, 0)
    padded_base = padded_cum - padded_sc
    total_needed = int(padded_cum[-1]) if c2 else 0

    tp = (n * k_cand + c2 * p) // p * p  # the JAX pool size (worst case)
    overflow = overflow | (total_needed > tp)

    # each padded slot pulls its pair from the sorted list; the slots
    # past total_needed are empty, so only the blocks before it are built
    slots = torch.arange(min(total_needed, tp), device=dev)
    slot_sc = torch.clamp_max(torch.searchsorted(padded_cum, slots,
                                                 right=True), c2 - 1)
    src = slots - padded_base[slot_sc] + base_sc[slot_sc]
    in_range = src < base_sc[slot_sc] + count_sc[slot_sc]
    src = torch.clamp(src, 0, n * k_cand - 1)
    pair_ray = torch.where(in_range, sorted_ray[src], -1)
    block_sc = slot_sc.reshape(-1, p)[:, 0]

    t_pair, tri_pair = _sweep(origins, directions, t_min, t_max, sc,
                              pair_ray.reshape(-1, p), block_sc)
    hit_pair = (tri_pair >= 0) & (pair_ray >= 0)
    safe_ray = torch.clamp_min(pair_ray, 0)

    if any_hit:
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        blocked[safe_ray[hit_pair]] = True
        return None, None, blocked, overflow

    # segment-min via order-preserving bits
    key = torch.where(hit_pair, _f32_sortable_bits(t_pair), NO_KEY)
    best_key = torch.full((n,), NO_KEY, dtype=torch.int64, device=dev
                          ).scatter_reduce(0, safe_ray, key, "amin")
    win = hit_pair & (key == best_key[safe_ray])
    best_tri = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev
                          ).scatter_reduce(
        0, safe_ray, torch.where(win, tri_pair, INT32_MAX), "amin")
    missed = best_key == NO_KEY
    return torch.where(missed, -1, best_tri), missed, None, overflow


def _batches(origins, directions, t_min, t_max, ray_batch: int):
    """The rays padded to whole batches (never-hit rays, t_max = -1), as
    (o, d, tn, tx) slices of ray_batch rays each."""
    batch = min(ray_batch, origins.shape[0])
    o, d, tn, tx, _ = _pad_rays(origins, directions, t_min, t_max, batch)
    return [(o[s:s + batch], d[s:s + batch], tn[s:s + batch],
             tx[s:s + batch]) for s in range(0, o.shape[0], batch)]


def closest_hit_scatter(sc: SuperClusters, tri_geometry: torch.Tensor,
                        tri_primitive: torch.Tensor, origins: torch.Tensor,
                        directions: torch.Tensor, t_min, t_max,
                        avg_candidates: int = AVG_CANDIDATES,
                        ray_batch: int = RAY_BATCH
                        ) -> tuple[HitRecord, torch.Tensor]:
    """Closest hit for a ray batch [N]: (HitRecord, overflowed), the
    latter a bool scalar tensor, True where some ray overlapped more than
    avg_candidates superclusters or the pair pool ran out (those pairs
    were dropped: a hit may be missed)."""
    n = origins.shape[0]
    t_min = _per_ray(t_min, n, origins)
    t_max_a = _per_ray(t_max, n, origins)
    outs = [_trace_scatter_batch(o, d, tn, tx, sc, avg_candidates,
                                 any_hit=False)
            for o, d, tn, tx in _batches(origins, directions, t_min, t_max_a,
                                         ray_batch)]
    tri = torch.cat([x[0] for x in outs])[:n]
    missed = torch.cat([x[1] for x in outs])[:n]
    overflowed = torch.stack([x[3] for x in outs]).any()

    # exact (t, u, v) by re-evaluating the winning triangle per ray: one
    # ray against a one-triangle block, with XLA's contraction of the JAX
    # re-evaluation
    safe_tri = torch.clamp_min(tri, 0).long()
    _, t, u, v = (x[:, 0, 0] for x in intersect_cluster_block(
        origins[:, None], directions[:, None], sc.tri_wald[safe_tri],
        t_min[:, None], t_max_a[:, None]))
    rec = HitRecord(
        t=torch.where(missed, t_max_a, t),
        u=torch.where(missed, 0.0, u),
        v=torch.where(missed, 0.0, v),
        geometry_index=torch.where(missed, INVALID_INDEX,
                                   tri_geometry[safe_tri].long()),
        primitive_id=torch.where(missed, 0, tri_primitive[safe_tri].long()),
        triangle_index=tri)
    return rec, overflowed


def occluded_scatter(sc: SuperClusters, origins: torch.Tensor,
                     directions: torch.Tensor, t_min, t_max,
                     avg_candidates: int = AVG_CANDIDATES,
                     ray_batch: int = RAY_BATCH
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Any-hit visibility batch: (blocked [N], overflowed), as
    closest_hit_scatter."""
    n = origins.shape[0]
    outs = [_trace_scatter_batch(o, d, tn, tx, sc, avg_candidates,
                                 any_hit=True)
            for o, d, tn, tx in _batches(
                origins, directions, _per_ray(t_min, n, origins),
                _per_ray(t_max, n, origins), ray_batch)]
    return (torch.cat([x[2] for x in outs])[:n],
            torch.stack([x[3] for x in outs]).any())
