"""Bundle traversal, port of raytracer2_tpu/ops/traverse_bundle.py: the
XLA bundle engine as torch ops (backend "bundle"), and the helpers the
bundle walk's candidate prep shares with it (ray padding, the Morton bit
spread, the per-bundle origin box and inverse-direction interval, the
coherence sort).

1. rays are grouped into fixed-size bundles; incoherent batches are sorted
   first by (direction octant, origin Morton, direction Morton)
   (sort_rays_for_coherence), so each bundle has a tight origin box and
   direction cone;
2. every bundle is tested against every cluster with the conservative
   interval slab test (cluster.bundle_cluster_overlap) and ranks all
   clusters by entry distance (a stable argsort, as jnp.argsort);
3. a loop walks each bundle's list front to back, CLUSTER_CHUNK clusters a
   step, testing every ray against every triangle of them (the JAX
   engine's cluster.intersect_cluster_block, here wald.hit_test). A
   closest-hit bundle stops once the next chunk's entry distance exceeds
   its worst committed hit; an any-hit bundle once every ray is blocked.

No Pallas kernel lies behind this engine, so it has no hand kernel: it is
torch ops on any device. The JAX loop steps every bundle of a ray batch in
lockstep and masks the finished ones; here each step takes the bundles
still walking (one host read-back a step, WalkStats.host_checks), which
changes no bundle's answer. The hits are tested with the float32 pass of
wald.hit_test (exact fused roundings on the lanes that could hit), so
hits, t, u and v equal the JAX engine's bit for bit. The JAX engine's
max_candidates argument, which its exact walk never reads, and its
BundleTraceResult, whose overflowed flag is always False, have no
counterpart.
"""

from __future__ import annotations

import torch

from raytracer2_tpu_torch.ops.cluster import Clusters, bundle_cluster_overlap
from raytracer2_tpu_torch.ops.intersect import INVALID_INDEX, HitRecord
from raytracer2_tpu_torch.ops.traverse import WalkStats
from raytracer2_tpu_torch.ops.wald import fused_tuv, hit_test
from raytracer2_tpu_torch.utils import readback

BUNDLE_SIZE = 128
RAY_BATCH = 65536  # rays per dispatch slice (bounds all-pairs intermediates)
CLUSTER_CHUNK = 16  # clusters intersected per loop step
# (ray, triangle) lanes of one step's test temporaries per device type
STEP_LANES = {"cuda": 1 << 25, "cpu": 1 << 22}


def _pad_rays(origins, directions, t_min, t_max, multiple: int):
    """Pad the ray batch to a multiple of `multiple` with rays that can
    never hit (t_max = -1). Returns (o, d, tn, tx, n_original)."""
    n = origins.shape[0]
    pad = (-n) % multiple
    if pad:
        dev = origins.device
        origins = torch.cat(
            [origins, torch.zeros((pad, 3), dtype=origins.dtype, device=dev)])
        directions = torch.cat(
            [directions, readback.constant(((0.0, 0.0, 1.0),), dev,
                                           directions.dtype).expand(pad, 3)])
        t_min = torch.cat(
            [t_min, torch.zeros((pad,), dtype=t_min.dtype, device=dev)])
        t_max = torch.cat(
            [t_max, torch.full((pad,), -1.0, dtype=t_max.dtype, device=dev)])
    return origins, directions, t_min, t_max, n


def _expand_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread the low `bits` bits with 2 zeros between each (morton helper);
    int64 tensors holding uint32 values."""
    v = v & ((1 << bits) - 1)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def sort_rays_for_coherence(origins: torch.Tensor, directions: torch.Tensor,
                            scene_min: torch.Tensor, scene_max: torch.Tensor
                            ) -> torch.Tensor:
    """The permutation (a stable argsort, as jnp.argsort) that sorts rays by
    the 32-bit key [octant:3 | origin Morton:15 | direction Morton:12]:
    origin-major grouping keeps rays with nearby origins together, and the
    direction Morton groups a pinhole camera's rays into screen tiles."""
    octant = ((directions[:, 0] >= 0).long()
              | ((directions[:, 1] >= 0).long() << 1)
              | ((directions[:, 2] >= 0).long() << 2))
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    q = torch.clamp((origins - scene_min) / extent, 0.0, 0.999)
    ocell = (q * 32.0).long()  # 5 bits per axis
    o_morton = (_expand_bits(ocell[:, 0], 5)
                | (_expand_bits(ocell[:, 1], 5) << 1)
                | (_expand_bits(ocell[:, 2], 5) << 2))
    dq = torch.clamp(directions * 0.5 + 0.5, 0.0, 0.999)
    dcell = (dq * 16.0).long()  # 4 bits per axis
    d_morton = (_expand_bits(dcell[:, 0], 4)
                | (_expand_bits(dcell[:, 1], 4) << 1)
                | (_expand_bits(dcell[:, 2], 4) << 2))
    key = (octant << 27) | (o_morton << 12) | d_morton
    return torch.argsort(key, stable=True)


def _bundle_bounds(origins, directions, t_max, bundle_size: int):
    """Per-bundle origin AABB + conservative 1/d interval. Padded rays
    (t_max < 0) are excluded from the bounds via +-big sentinels."""
    b = origins.shape[0] // bundle_size
    o = origins.reshape(b, bundle_size, 3)
    d = directions.reshape(b, bundle_size, 3)
    tm = t_max.reshape(b, bundle_size)
    live = (tm >= 0.0)[..., None]

    big = 3e38
    o_min = torch.where(live, o, big).amin(dim=1)
    o_max = torch.where(live, o, -big).amax(dim=1)
    d_min = torch.where(live, d, big).amin(dim=1)
    d_max = torch.where(live, d, -big).amax(dim=1)

    # conservative reciprocal interval; sign change across the bundle ->
    # unbounded axis (inf sentinels understood by the overlap test)
    spans_zero = (d_min <= 0.0) & (d_max >= 0.0)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12,
                           torch.where(x >= 0, 1e-12, -1e-12), x)

    inv_a = 1.0 / safe(d_min)
    inv_b = 1.0 / safe(d_max)
    inv_lo = torch.minimum(inv_a, inv_b)
    inv_hi = torch.maximum(inv_a, inv_b)
    inv_lo = torch.where(spans_zero, -torch.inf, inv_lo)
    inv_hi = torch.where(spans_zero, torch.inf, inv_hi)

    bundle_tmax = torch.where(live[..., 0], tm, 0.0).amax(dim=1)
    return o_min, o_max, inv_lo, inv_hi, bundle_tmax


def _bundle_entries(origins, directions, t_max, clusters: Clusters,
                    bundle_size: int):
    """[B, C] conservative entry distance of every bundle into every
    cluster (+inf where the interval test rules it out), clamped at 0."""
    o_min, o_max, inv_lo, inv_hi, bundle_tmax = _bundle_bounds(
        origins, directions, t_max, bundle_size)
    may_hit, t_enter = bundle_cluster_overlap(
        o_min, o_max, inv_lo, inv_hi, bundle_tmax,
        clusters.aabb_min, clusters.aabb_max)
    return torch.where(may_hit, torch.clamp_min(t_enter, 0.0), torch.inf)


def _step(rays, best, cand_idx, step, clusters: Clusters, chunk: int,
          any_hit: bool) -> None:
    """One walk step of the bundles `rays` [nb, R, 8] (rows of the
    bundles whose state `best` = (t, u, v, tri) [nb, R] holds): their
    chunk of candidates at step `step` [nb], tested against every ray, the
    state updated in place as JAX's loop body updates it."""
    best_t, best_u, best_v, best_tri = best
    nb, r = rays.shape[:2]
    s = clusters.cluster_size
    k = cand_idx.shape[1]
    base = torch.clamp_max(step * chunk, k - chunk)
    cols = base[:, None] + torch.arange(chunk, device=rays.device)
    ci = torch.gather(cand_idx, 1, cols).long()  # [nb, chunk]
    # Wald rows [nb, 12, 1, chunk*S]: row k*3 + c is input k of output c,
    # lane g*S + s is triangle s of the chunk's cluster g (JAX's layout of
    # the fused [4, chunk*3S] block)
    wr = (clusters.wald[ci].reshape(nb, chunk, 4, s, 3)
          .permute(0, 2, 4, 1, 3).reshape(nb, 12, 1, chunk * s))
    tri_ids = clusters.tri_index[ci].reshape(nb, chunk * s)
    t, hit = hit_test(rays, wr)
    hit &= (t < best_t[..., None]) & (tri_ids >= 0)[:, None, :]
    if any_hit:
        blocked = hit.any(dim=-1)
        best_tri.copy_(torch.where(blocked & (best_tri < 0), 0x7FFFFFFF,
                                   best_tri))
        best_t.copy_(torch.where(blocked, -1.0, best_t))
        return
    t_best, arg = torch.where(hit, t, torch.inf).min(dim=-1)  # first index
    better = t_best < best_t
    bi, ri = torch.nonzero(better, as_tuple=True)
    if bi.numel():
        lane = arg[bi, ri]
        _, uu, vv, _ = fused_tuv(rays[bi, ri], wr[bi, :, 0, lane])
        best_u.index_put_((bi, ri), uu)
        best_v.index_put_((bi, ri), vv)
        best_tri.index_put_((bi, ri), tri_ids[bi, lane])
        best_t.index_put_((bi, ri), t_best[bi, ri])


def _trace_bundles(origins, directions, t_min, t_max, clusters: Clusters,
                   bundle_size: int, any_hit: bool,
                   cluster_chunk: int = CLUSTER_CHUNK,
                   stats: WalkStats | None = None):
    """Core loop shared by closest hit and any hit (JAX _trace_bundles):
    (t, u, v, tri) per ray of a batch of whole bundles."""
    b = origins.shape[0] // bundle_size
    dev = origins.device
    c = clusters.num_clusters
    entry = _bundle_entries(origins, directions, t_max, clusters,
                            bundle_size)
    chunk = min(cluster_chunk, c)
    k = ((c + chunk - 1) // chunk) * chunk
    order = torch.argsort(entry, dim=-1, stable=True)  # [B, C] ascending
    cand_t = torch.gather(entry, 1, order)
    if k > c:  # pad candidate lists to the chunk multiple
        cand_t = torch.nn.functional.pad(cand_t, (0, k - c), value=torch.inf)
        order = torch.nn.functional.pad(order, (0, k - c))
    cand_idx = order.to(torch.int32)
    cand_count = torch.isfinite(cand_t).sum(dim=-1)

    rays = torch.cat([origins, directions, t_min[:, None], t_max[:, None]],
                     dim=1).reshape(b, bundle_size, 8)
    best_t = t_max.reshape(b, bundle_size).clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_tri = torch.full((b, bundle_size), -1, dtype=torch.int32,
                          device=dev)
    step = torch.zeros(b, dtype=torch.int64, device=dev)
    per_step = max(1, STEP_LANES[dev.type] // (bundle_size * chunk
                                               * clusters.cluster_size))
    steps = checks = 0
    while True:
        active = step * chunk < cand_count
        next_t = torch.gather(cand_t, 1, torch.clamp_max(
            step * chunk, k - 1)[:, None])[:, 0]
        if any_hit:
            active &= (best_t >= 0.0).any(dim=-1)
        else:
            # early out: the next chunk enters beyond the worst live hit
            active &= next_t <= best_t.amax(dim=-1)
        live = readback.nonzero(active, "bundle_engine_check")
        checks += 1
        if live.numel() == 0:
            break
        for s0 in range(0, live.numel(), per_step):
            ids = live[s0:s0 + per_step]
            best = tuple(x[ids] for x in (best_t, best_u, best_v, best_tri))
            _step(rays[ids], best, cand_idx[ids], step[ids], clusters, chunk,
                  any_hit)
            for dst, src in zip((best_t, best_u, best_v, best_tri), best):
                dst[ids] = src
        step += active.long()
        steps += 1
    if stats is not None:
        stats.calls += 1
        stats.steps += steps
        stats.host_checks += checks
    return (best_t.reshape(-1), best_u.reshape(-1), best_v.reshape(-1),
            best_tri.reshape(-1))


def _bundle_candidate_counts(origins, directions, t_max, clusters,
                             bundle_size) -> torch.Tensor:
    """[B] number of clusters each bundle's frustum may touch (the
    conservative overlap test)."""
    o_min, o_max, inv_lo, inv_hi, bundle_tmax = _bundle_bounds(
        origins, directions, t_max, bundle_size)
    may_hit, _ = bundle_cluster_overlap(
        o_min, o_max, inv_lo, inv_hi, bundle_tmax,
        clusters.aabb_min, clusters.aabb_max)
    return may_hit.sum(dim=-1).to(torch.int32)


def _trace_batched(origins, directions, t_min, t_max, clusters,
                   bundle_size, any_hit,
                   ray_batch: int = RAY_BATCH,
                   cluster_chunk: int = CLUSTER_CHUNK,
                   stats: WalkStats | None = None):
    """Work-efficient dispatch (JAX _trace_batched): bundles sorted by
    candidate count, then sliced into fixed ray batches, each walked on
    its own, so light batches retire in a few steps. Also bounds the
    [bundles, C] cull and ranking temporaries."""
    n = origins.shape[0]
    origins, directions, t_min, t_max, _ = _pad_rays(
        origins, directions, t_min, t_max, bundle_size)
    n_padded = origins.shape[0]

    batch = min(ray_batch, n_padded)
    batch = max((batch // bundle_size) * bundle_size, bundle_size)
    nb = (n_padded + batch - 1) // batch

    ray_perm = None
    if nb > 1:  # sort bundles by workload
        counts = _bundle_candidate_counts(
            origins, directions, t_max, clusters, bundle_size)
        bundle_order = torch.argsort(counts, stable=True)
        ray_perm = (bundle_order[:, None] * bundle_size + torch.arange(
            bundle_size, device=origins.device)).reshape(-1)
        origins, directions = origins[ray_perm], directions[ray_perm]
        t_min, t_max = t_min[ray_perm], t_max[ray_perm]
    origins, directions, t_min, t_max, _ = _pad_rays(
        origins, directions, t_min, t_max, batch)

    outs = [_trace_bundles(origins[s:s + batch], directions[s:s + batch],
                           t_min[s:s + batch], t_max[s:s + batch], clusters,
                           bundle_size, any_hit, cluster_chunk, stats)
            for s in range(0, nb * batch, batch)]
    bt, u, v, tri = (torch.cat(x)[:n_padded] for x in zip(*outs))
    if ray_perm is not None:
        bt, u, v, tri = (torch.empty_like(x).index_put_((ray_perm,), x)
                         for x in (bt, u, v, tri))
    return bt[:n], u[:n], v[:n], tri[:n]


def _per_ray(x, n: int, ref: torch.Tensor) -> torch.Tensor:
    """A scalar or [n] segment end as a contiguous float32 [n] on ref's
    device."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=ref.device).expand(n).contiguous()


def _sorted_batch(origins, directions, t_min, t_max, scene_min, scene_max,
                  sort_rays: bool):
    n = origins.shape[0]
    tn, tx = _per_ray(t_min, n, origins), _per_ray(t_max, n, origins)
    if not sort_rays:
        return None, origins, directions, tn, tx, tx
    perm = sort_rays_for_coherence(origins, directions, scene_min, scene_max)
    return (perm, origins[perm], directions[perm], tn[perm], tx[perm], tx)


def _unsort(x: torch.Tensor, perm) -> torch.Tensor:
    if perm is None:
        return x
    return torch.empty_like(x).index_put_((perm,), x)


def closest_hit_bundle(clusters: Clusters, tri_geometry: torch.Tensor,
                       tri_primitive: torch.Tensor, origins: torch.Tensor,
                       directions: torch.Tensor, t_min, t_max,
                       scene_min: torch.Tensor, scene_max: torch.Tensor,
                       bundle_size: int = BUNDLE_SIZE,
                       sort_rays: bool = False,
                       cluster_chunk: int = CLUSTER_CHUNK,
                       ray_batch: int = RAY_BATCH,
                       stats: WalkStats | None = None) -> HitRecord:
    """Closest hit for a ray batch [N]. Set sort_rays=True for incoherent
    batches (bounce / light rays). stats, if given, sums the walk's steps
    and host read-backs."""
    perm, o, d, tn, tx, tx_orig = _sorted_batch(
        origins, directions, t_min, t_max, scene_min, scene_max, sort_rays)
    best_t, u, v, tri = _trace_batched(
        o, d, tn, tx, clusters, bundle_size, any_hit=False,
        ray_batch=ray_batch, cluster_chunk=cluster_chunk, stats=stats)
    best_t, u, v, tri = (_unsort(x, perm) for x in (best_t, u, v, tri))
    missed = tri < 0
    safe = torch.clamp_min(tri, 0).long()
    return HitRecord(
        t=torch.where(missed, tx_orig, best_t), u=u, v=v,
        geometry_index=torch.where(missed, INVALID_INDEX,
                                   tri_geometry[safe].long()),
        primitive_id=torch.where(missed, 0, tri_primitive[safe].long()),
        triangle_index=tri)


def occluded_bundle(clusters: Clusters, origins: torch.Tensor,
                    directions: torch.Tensor, t_min, t_max,
                    scene_min: torch.Tensor, scene_max: torch.Tensor,
                    bundle_size: int = BUNDLE_SIZE,
                    sort_rays: bool = True,
                    cluster_chunk: int = CLUSTER_CHUNK,
                    ray_batch: int = RAY_BATCH,
                    stats: WalkStats | None = None) -> torch.Tensor:
    """Any-hit visibility batch: True where blocked."""
    perm, o, d, tn, tx, _ = _sorted_batch(
        origins, directions, t_min, t_max, scene_min, scene_max, sort_rays)
    _, _, _, tri = _trace_batched(
        o, d, tn, tx, clusters, bundle_size, any_hit=True,
        ray_batch=ray_batch, cluster_chunk=cluster_chunk, stats=stats)
    return _unsort(tri >= 0, perm)
