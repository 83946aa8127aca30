"""LBVH construction: Morton sort + Karras binary radix tree, port of
raytracer2_tpu/ops/bvh.py.

1. triangle centroids quantized to a 2^10 grid of the scene AABB;
2. 30-bit Morton codes, stably sorted;
3. binary radix tree built in parallel per internal node (Karras 2012,
   "Maximizing Parallelism in the Construction of BVHs...") using
   common-prefix lengths with index tiebreak, so duplicate codes still
   produce a valid topology;
4. AABB fit by iterated child-union gathers (bounded by tree depth,
   <= ~32 + log2(N) with the tiebreak).

The loops run exactly the JAX version's counts (31 doubling, 32 range and
32 split steps, 34 + ceil(log2 N) fits) with its int32 shift semantics,
so every output is bit-equal to it. uint32 Morton arithmetic is carried in
int64 and masked to 32 bits.

Node layout (N leaves, N-1 internal nodes, root = 0):
- `left`/`right` [N-1] int32 child ids; id < N-1 is internal, id >= N-1 is
  the leaf holding sorted-triangle (id - (N-1));
- `aabb_min`/`aabb_max` [2N-1, 3] for internal then leaf nodes;
- `tri_order` [N] maps sorted leaf position -> original triangle index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_U32 = 0xFFFFFFFF


class BVH(NamedTuple):
    left: torch.Tensor  # [N-1] int32
    right: torch.Tensor  # [N-1] int32
    aabb_min: torch.Tensor  # [2N-1, 3] f32
    aabb_max: torch.Tensor  # [2N-1, 3] f32
    tri_order: torch.Tensor  # [N] int32 sorted -> original triangle index
    num_leaves: int


def _levels(bvh: BVH):
    """Breadth-first levels from the root: yields (nodes, right_edges) per
    level, right_edges counting the right-child steps from the root to
    each node. Raises if the child links run longer than a tree can."""
    n_int = bvh.left.shape[0]
    children = torch.stack([bvh.left, bvh.right], dim=1).long()
    nodes = torch.zeros(1, dtype=torch.long, device=bvh.left.device)
    rights = torch.zeros_like(nodes)
    for _ in range(n_int + bvh.num_leaves):
        if nodes.numel() == 0:
            return
        yield nodes, rights
        inner = nodes < n_int
        nodes = children[nodes[inner]].reshape(-1)
        rights = (rights[inner][:, None]
                  + torch.tensor([0, 1], device=nodes.device)).reshape(-1)
    raise ValueError("the BVH's child links do not form a tree")


def max_depth(bvh: BVH) -> int:
    """Tree depth (root = 1), level by level on the BVH's device. The
    traversal's short stack must cover it (render/app_bridge.py asserts
    this instead of silently clamping on overflow, which drops
    subtrees)."""
    return sum(1 for _ in _levels(bvh))


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zeros between each bit
    (uint32 arithmetic in int64)."""
    v = v.long() & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton_codes_3d(points: torch.Tensor, box_min: torch.Tensor,
                    box_max: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for [N, 3] float32 points inside the
    given AABB."""
    extent = torch.clamp_min(box_max - box_min, 1e-12)
    q = torch.clamp((points - box_min) / extent, 0.0, 0.9999999)
    cells = (q * 1024.0).long()
    return (_expand_bits_10(cells[:, 0]) * 4
            + _expand_bits_10(cells[:, 1]) * 2
            + _expand_bits_10(cells[:, 2]))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the low 32 bits of int64 x, 32 for 0 (as
    jax.lax.clz on uint32)."""
    x = x & _U32
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        top_zero = x < (1 << (32 - shift))
        n = n + torch.where(top_zero, shift, 0)
        x = torch.where(top_zero, (x << shift) & _U32, x)
    return torch.where(x == 0, 32, n)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement wrap of its value."""
    return ((x + (1 << 31)) & _U32) - (1 << 31)


def _shl_i32(p: int) -> int:
    """1 << p as XLA computes it on int32 (0 for p >= 32)."""
    return 0 if p >= 32 else ((1 << p) + (1 << 31)) % (1 << 32) - (1 << 31)


def _fit_iters(n: int) -> int:
    """34 + max(1, ceil(log2 n)), log2 taken in float32 as jnp.log2 of a
    Python int takes it."""
    return 34 + max(1, int(np.ceil(np.log2(np.float32(n)))))


def build_lbvh(tri_v0: torch.Tensor, tri_edge1: torch.Tensor,
               tri_edge2: torch.Tensor) -> BVH:
    """Build the LBVH over a world-space triangle soup ([T, 3] float32 on
    any device; the BVH lands there). Requires T >= 2."""
    n = tri_v0.shape[0]
    if n < 2:
        raise ValueError("build_lbvh requires at least 2 triangles")
    dev = tri_v0.device

    v1 = tri_v0 + tri_edge1
    v2 = tri_v0 + tri_edge2
    tmin = torch.minimum(torch.minimum(tri_v0, v1), v2)
    tmax = torch.maximum(torch.maximum(tri_v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    codes = morton_codes_3d(centroid, centroid.amin(dim=0),
                            centroid.amax(dim=0))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    tri_order = order.to(torch.int32)

    i = torch.arange(n - 1, dtype=torch.long, device=dev)  # internal ids

    def delta(j: torch.Tensor) -> torch.Tensor:
        """Common-prefix length of codes i and j with index tiebreak; -1
        out of range."""
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = codes[i] ^ codes[jc]
        tie = 32 + _clz32(i ^ jc)
        d = torch.where(x == 0, tie, _clz32(x))
        return torch.where(valid, d, -1)

    d = torch.where(delta(i + 1) > delta(i - 1), 1, -1)
    delta_min = delta(i - d)

    # upper bound for the range length by doubling (31 steps)
    l_max = torch.full((n - 1,), 2, dtype=torch.long, device=dev)
    for _ in range(31):
        cand = _i32(l_max * 2)
        l_max = torch.where(delta(i + cand * d) > delta_min, cand, l_max)
    l_max = _i32(l_max * 2)  # strictly above the true length

    # binary search of the exact length (32 steps, k + 1 up to 32: XLA's
    # arithmetic shift fills with the sign past 31)
    l = torch.zeros_like(l_max)
    for k in range(32):
        t = l_max >> min(k + 1, 31)
        ok = (t >= 1) & (delta(i + (l + t) * d) > delta_min)
        l = l + torch.where(ok, t, 0)
    j = i + l * d
    delta_node = delta(j)

    # split search: t halves (rounded up) each step; 1 << (k + 1) is an
    # int32 that wraps at k = 30 and is 0 at k = 31, as in XLA
    s = torch.zeros_like(l)
    for k in range(32):
        t = _i32(l + (_shl_i32(k + 1) - 1)) >> min(k + 1, 31)
        ok = (t >= 1) & (delta(i + (s + t) * d) > delta_node)
        s = s + torch.where(ok, t, 0)
    gamma = i + s * d + torch.clamp_max(d, 0)

    range_lo = torch.minimum(i, j)
    range_hi = torch.maximum(i, j)
    leaf_base = n - 1
    left = torch.where(range_lo == gamma, leaf_base + gamma, gamma)
    right = torch.where(range_hi == gamma + 1, leaf_base + gamma + 1,
                        gamma + 1)

    # AABB fit: leaves, then iterated child unions for the internal nodes
    big = 3.0e38
    aabb_min = torch.cat([torch.full((n - 1, 3), big, device=dev),
                          tmin[order]])
    aabb_max = torch.cat([torch.full((n - 1, 3), -big, device=dev),
                          tmax[order]])
    for _ in range(_fit_iters(n)):
        new_min = torch.minimum(aabb_min[left], aabb_min[right])
        new_max = torch.maximum(aabb_max[left], aabb_max[right])
        aabb_min = torch.cat([new_min, aabb_min[n - 1:]])
        aabb_max = torch.cat([new_max, aabb_max[n - 1:]])

    return BVH(left=left.to(torch.int32), right=right.to(torch.int32),
               aabb_min=aabb_min, aabb_max=aabb_max, tri_order=tri_order,
               num_leaves=n)


def validate_bvh(bvh: BVH) -> dict:
    """Structural validation: every leaf reachable exactly once from the
    root, children inside their parent's box (1e-5 slack). Returns
    {"max_depth": the deepest stack of the JAX version's depth-first walk,
    which pushes left then right}: 1 + the most right-child steps on a
    root-to-node path. Raises ValueError on a fault."""
    n = bvh.num_leaves
    n_int = n - 1
    left, right = bvh.left.long(), bvh.right.long()
    amin, amax = bvh.aabb_min, bvh.aabb_max
    for c in (left, right):
        if (bool((amin[c] < amin[:n_int] - 1e-5).any())
                or bool((amax[c] > amax[:n_int] + 1e-5).any())):
            raise ValueError("child box escapes parent")
    seen = torch.zeros(n, dtype=torch.long, device=left.device)
    most_right = 0
    for nodes, rights in _levels(bvh):
        leaves = nodes[nodes >= n_int] - n_int
        seen += torch.bincount(leaves, minlength=n)
        most_right = max(most_right, int(rights.max()))
    if not bool((seen == 1).all()):
        raise ValueError("leaves not covered exactly once")
    return {"max_depth": 1 + most_right}
