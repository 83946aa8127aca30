"""BVH traversal: closest-hit and any-hit queries over the LBVH, port of
raytracer2_tpu/ops/traverse.py.

Per ray, the JAX version's short-stack walk step for step: pop a node,
test its triangle if it is a leaf, push the children whose boxes the ray
enters (the closest-hit walk pushes the far child first so the near one
pops first, and tests boxes against its best t so far; the any-hit walk
pushes right then left and tests against t_max), the stack pointer
clamped to STACK_SIZE - 1. The JAX version vmaps a while_loop; here one
iteration steps every live ray at once as torch ops on a [live,
STACK_SIZE] stack, and every CHECK_EVERY steps the host drops the
finished rays (one read-back) and stops when none is left. Batching and
compaction change no ray's answer.

Returns exactly the reference's payload (t, u, v, geometryIndex,
primitiveId; common.glsl:23-28), INVALID on miss.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer2_tpu_torch.ops.bvh import BVH
from raytracer2_tpu_torch.ops.intersect import (
    INVALID_INDEX, HitRecord, _per_ray, moller_trumbore, safe_inv_dir)
from raytracer2_tpu_torch.utils import readback

STACK_SIZE = 64  # checked against max_depth(bvh) when the tracers are made
CHECK_EVERY = 8  # walk steps between the host's looks at the live set


@dataclasses.dataclass
class WalkStats:
    """Summed over calls: the walk steps (one per loop iteration over the
    live rays) and the host's looks at the live set."""

    calls: int = 0
    steps: int = 0
    host_checks: int = 0


def _slab(boxes, node, origin, inv_dir, t_min, upper):
    """Slab test of each ray against boxes[node] ([.., 6]: min, max)."""
    b = boxes[node]
    t0 = (b[:, :3] - origin) * inv_dir
    t1 = (b[:, 3:] - origin) * inv_dir
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (near <= far) & (far >= t_min) & (near <= upper), near


def _write(stack, rows, slot, node, push) -> None:
    """stack[slot] = node where push; the slot keeps its value elsewhere."""
    stack[rows, slot] = torch.where(push, node, stack[rows, slot])


def _walk(bvh: BVH, tri_v0, tri_edge1, tri_edge2, origins, directions,
          t_min, t_max, closest: bool, stats: WalkStats | None):
    """The walk over all rays: (best_t, best_u, best_v, best_leaf) for the
    closest hit, or the blocked mask for the any hit."""
    n = origins.shape[0]
    dev = origins.device
    n_internal = bvh.num_leaves - 1
    boxes = torch.cat([bvh.aabb_min, bvh.aabb_max], dim=1)
    children = torch.stack([bvh.left, bvh.right], dim=1).long()
    order = bvh.tri_order.long()
    leaf_tris = torch.stack([tri_v0[order], tri_edge1[order],
                             tri_edge2[order]], dim=1)  # [N, 3, 3]

    out_t = t_max.clone()
    out_u = torch.zeros(n, device=dev)
    out_v = torch.zeros(n, device=dev)
    out_leaf = torch.full((n,), -1, dtype=torch.long, device=dev)
    out_blocked = torch.zeros(n, dtype=torch.bool, device=dev)

    # the live rays' state
    ids = torch.arange(n, device=dev)
    o, d, tn, tx = origins, directions, t_min, t_max
    inv = safe_inv_dir(d)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.long, device=dev)
    best_t, best_u, best_v = out_t.clone(), out_u.clone(), out_v.clone()
    best_leaf = out_leaf.clone()
    blocked = out_blocked.clone()

    steps = checks = 0
    while ids.numel():
        rows = torch.arange(ids.numel(), device=dev)
        for _ in range(CHECK_EVERY):
            active = (sp > 0) & ~blocked
            sp_pop = torch.clamp_min(sp - 1, 0)
            node = stack[rows, sp_pop].long()
            is_leaf = node >= n_internal

            leaf_id = torch.clamp_min(node - n_internal, 0)
            tri = leaf_tris[leaf_id]
            hit, t, u, v = moller_trumbore(
                o, d, tri[:, 0], tri[:, 1], tri[:, 2], tn,
                best_t if closest else tx)
            take = active & is_leaf & hit
            inner = active & ~is_leaf
            if closest:
                best_u = torch.where(take, u, best_u)
                best_v = torch.where(take, v, best_v)
                best_leaf = torch.where(take, leaf_id, best_leaf)
                best_t = torch.where(take, t, best_t)
            else:
                blocked = blocked | take

            kids = children[torch.clamp_max(node, n_internal - 1)]
            lc, rc = kids[:, 0], kids[:, 1]
            upper = best_t if closest else tx
            lhit, lnear = _slab(boxes, lc, o, inv, tn, upper)
            rhit, rnear = _slab(boxes, rc, o, inv, tn, upper)
            lhit = lhit & inner
            rhit = rhit & inner
            if closest:
                # push the far child first so the near one pops first
                swap = rnear < lnear
                first = torch.where(swap, rc, lc)
                first_hit = torch.where(swap, rhit, lhit)
                second = torch.where(swap, lc, rc)
                second_hit = torch.where(swap, lhit, rhit)
            else:
                first, first_hit, second, second_hit = lc, lhit, rc, rhit
            first, second = first.to(torch.int32), second.to(torch.int32)
            nsp = sp_pop
            _write(stack, rows, nsp, second, second_hit)
            nsp = nsp + second_hit.long()
            _write(stack, rows, torch.clamp_max(nsp, STACK_SIZE - 1), first,
                   first_hit)
            nsp = nsp + first_hit.long()
            sp = torch.where(active, torch.clamp_max(nsp, STACK_SIZE - 1),
                             sp)
            steps += 1

        # the host's look: write every live ray back, keep the unfinished
        checks += 1
        if closest:
            out_t[ids], out_u[ids], out_v[ids] = best_t, best_u, best_v
            out_leaf[ids] = best_leaf
        else:
            out_blocked[ids] = blocked
        keep = readback.nonzero((sp > 0) & ~blocked, "lbvh_check")
        ids, o, d, tn, tx, inv, stack, sp = (
            x[keep] for x in (ids, o, d, tn, tx, inv, stack, sp))
        best_t, best_u, best_v, best_leaf, blocked = (
            x[keep] for x in (best_t, best_u, best_v, best_leaf, blocked))

    if stats is not None:
        stats.calls += 1
        stats.steps += steps
        stats.host_checks += checks
    if closest:
        return out_t, out_u, out_v, out_leaf
    return out_blocked


def closest_hit(bvh: BVH, tri_v0: torch.Tensor, tri_edge1: torch.Tensor,
                tri_edge2: torch.Tensor, tri_geometry: torch.Tensor,
                tri_primitive: torch.Tensor, origins: torch.Tensor,
                directions: torch.Tensor, t_min, t_max,
                stats: WalkStats | None = None) -> HitRecord:
    """Closest-hit query for a ray batch [N, 3] -> HitRecord; `stats`, if
    given, gains this call's steps and host checks."""
    n = origins.shape[0]
    t_lo = _per_ray(t_min, n, origins)
    t_hi = _per_ray(t_max, n, origins)
    best_t, best_u, best_v, best_leaf = _walk(
        bvh, tri_v0, tri_edge1, tri_edge2, origins, directions, t_lo, t_hi,
        closest=True, stats=stats)
    missed = best_leaf < 0
    tri = bvh.tri_order[torch.clamp_min(best_leaf, 0)].long()
    geom = torch.where(missed, INVALID_INDEX, tri_geometry[tri].long())
    prim = torch.where(missed, 0, tri_primitive[tri].long())
    return HitRecord(
        t=torch.where(missed, t_hi, best_t), u=best_u, v=best_v,
        geometry_index=geom, primitive_id=prim,
        triangle_index=torch.where(missed, -1, tri).to(torch.int32))


def occluded(bvh: BVH, tri_v0: torch.Tensor, tri_edge1: torch.Tensor,
             tri_edge2: torch.Tensor, origins: torch.Tensor,
             directions: torch.Tensor, t_min, t_max,
             stats: WalkStats | None = None) -> torch.Tensor:
    """Any-hit visibility batch query: True where blocked."""
    n = origins.shape[0]
    return _walk(bvh, tri_v0, tri_edge1, tri_edge2, origins, directions,
                 _per_ray(t_min, n, origins), _per_ray(t_max, n, origins),
                 closest=False, stats=stats)
