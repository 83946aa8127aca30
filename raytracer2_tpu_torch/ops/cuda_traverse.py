"""Closest-hit and any-hit traversal through the hand-written CUDA walks.

Port of the host side of raytracer2_tpu/ops/pallas_traverse.py
(closest_hit_bundle_pallas, occluded_bundle_pallas, _prep and its culls
and sort keys), plus the wrappers of the kernels that replace its Pallas
walks (csrc/bundle_walk.cu, csrc/bundle_occlude.cu) and of the closest-hit
winner decode's kernel (csrc/hit_decode.cu; JAX decodes with XLA ops), and
those kernels' plain torch versions.

The culls (JAX's _prep dispatch; "auto" is "exact"):
- "interval": each bundle's candidates come from the conservative interval
  slab test over all cluster boxes (bundle_cluster_overlap). Presorted
  rays (pixel tiles in screen Z-order) keep their order; others are sorted
  by the coherence key (traverse_bundle.sort_rays_for_coherence) or, with
  sort_key="octz", by octz_sort_key.
- "exact_iv": rays sorted by the cand0 key, candidates from the interval
  test as above.
- "exact": every ray is slab-tested exactly against every cluster box (B4,
  a chunked dense [rays, C] pass), rays are sorted by a key (unless
  presorted), and each bundle's candidate list is the union of its rays'
  overlaps, ranked nearest first. The keys: "cand0" (nearest overlapped
  cluster | t_max bucket | octant | origin Morton; the dense pass is B3),
  "sc4" (cand0 over 4-cluster supercluster boxes), "hier" (nearest
  supercluster of 32, then its nearest cluster), "octz" (octant | t_max
  bucket | arrival rank, no dense pass) and "cand2" (the two nearest
  clusters).
- "hier": the dense pass runs against 32-cluster supercluster boxes, then
  only the clusters of each bundle's k_sc nearest superclusters are refined
  exactly; a bundle that overlaps more superclusters overflows.
- "sc": candidates are supercluster ids, full-length lists with no
  truncation, and the walks take one supercluster of m clusters a step
  (walk_closest_sc, walk_occluded_sc).

Ranking uses a stable argsort and keeps the first k: jax.lax.top_k breaks
ties by lower index and jnp.argsort is stable, so the candidate order
matches the JAX package's exactly (torch.topk promises no tie order).
uint32 keys are built in int64 with explicit masks.

A bundle whose union exceeds k_cand (or, under "hier", whose superclusters
exceed k_sc) overflows. Those bundles re-trace through the same kernel
with the exact cull and full-length lists (k_cand = C, exact by
construction); past FALLBACK_BUNDLES of them the whole batch re-traces at
k_cand = C ("hier" with the exact cull).

The function-level knobs of JAX's walks (closest_hit_bundle_pallas,
occluded_bundle_pallas), none of which changes a hit:
- depth: the kernels' cluster ring's slots (1-4). None keeps the card's
  4; JAX's TPU default of 2 was a DMA-slot count.
- mb: the bundles one block walks in turn. None keeps one a block; JAX's
  TPU default of 8 was a grid shape.
- lean (closest hit): the walk returns (best key, winning step) and the
  host recovers the cluster with one gather into the candidate table.
- debug_steps: (result, {"steps", "cand_count", "overflowed"}) with each
  bundle's walk steps, and no fallback.
- t_cap (the exact cull): each ray's t_max clamped to the farthest exit of
  the cluster boxes it overlaps (B4's cap output), after the union.
- mm: the Wald affines as matrix products: the kernels' tensor-core form
  (3xTF32 mma.sync), whose plain version is hit_test_mm; held to the
  oracle, not bit for bit.
"sc" ignores lean and mm, as JAX does.

The exact cull's two dense [rays, C] passes, the cand0 key's nearest box
and the per-bundle union, are the kernels of ops/cull.py (B3, B4): the
JAX package's cull_kernel option is not a knob here, those kernels are the
card's only form of the passes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer2_tpu_torch.ops import cull as cull_mod
from raytracer2_tpu_torch.ops.cluster import Clusters, bundle_cluster_overlap
from raytracer2_tpu_torch.ops.intersect import INVALID_INDEX, HitRecord
from raytracer2_tpu_torch.ops import traverse_bundle as tb
from raytracer2_tpu_torch.ops.traverse_bundle import (
    _bundle_bounds, _expand_bits, _pad_rays, _per_ray, _unsort)
from raytracer2_tpu_torch.ops.wald import fma, hit_test, hit_test_mm
from raytracer2_tpu_torch.utils import readback
from raytracer2_tpu_torch.utils.profiler import count, span

LANE_PAD = 128  # triangles per cluster row, padded to the lane width
SLOT_BITS = 10  # group * S_pad <= 1024; low key bits carry the winning slot
SLOT_MASK = (1 << SLOT_BITS) - 1
MISS_CODE = 0x7FFFFFFF
NO_HIT_KEY = 0x7FFFFFFF  # above every hit key and every initial key

# elements of one [bundles, P, group*S_pad] temporary of the plain walk
REFERENCE_CHUNK_ELEMS = {"cuda": 1 << 25, "cpu": 1 << 22}
FALLBACK_BUNDLES = 32  # past this many overflowed bundles, re-trace the batch
MAX_BUNDLE = 256  # rays per bundle a kernel takes (csrc/walk_common.cuh)
DEPTHS = (1, 2, 3, 4)  # the walk kernels' ring depths (kDepth instances)
DEPTH = 4  # the card's ring depth (walk_common.cuh::kRing)


# ---------------------------------------------------------------------------
# Per-scene tables
# ---------------------------------------------------------------------------

def s_pad(clusters: Clusters) -> int:
    s = clusters.cluster_size
    return ((s + LANE_PAD - 1) // LANE_PAD) * LANE_PAD


def wald_rows(clusters: Clusters) -> torch.Tensor:
    """[C, 4, 3S] -> [C, 16, S_pad]: row (k*3 + c) holds transform input k
    (x, y, z, bias) for output component c (u, v, z); rows 12:16 and the
    padding lanes are zero (d'_z == 0 -> never hit)."""
    c, _, w3 = clusters.wald.shape
    s = w3 // 3
    rows = (clusters.wald.reshape(c, 4, s, 3)
            .permute(0, 1, 3, 2)  # [C, 4, 3, S]
            .reshape(c, 12, s))
    return torch.nn.functional.pad(rows, (0, s_pad(clusters) - s, 0, 4))


def sc_layout(rows: torch.Tensor, m: int) -> torch.Tensor:
    """[C, R, W] per-cluster rows -> [C2, R, m*W] with C2 = ceil(C / m):
    supercluster s's m clusters side by side in the last dimension, cluster
    g at g*W + lane. The clusters that pad C up to C2*m are zero (False)
    rows."""
    c, r, w = rows.shape
    n_sc = (c + m - 1) // m
    rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, n_sc * m - c))
    return (rows.reshape(n_sc, m, r, w).permute(0, 2, 1, 3)
            .reshape(n_sc, r, m * w).contiguous())


def wald_sc_rows(clusters: Clusters, m: int) -> torch.Tensor:
    """[C2, 16, m*S_pad] (JAX _wald_sc_rows): supercluster s's m clusters
    side by side in the lane dimension, cluster g at lanes g*S_pad + lane;
    the clusters padding C to C2*m are zero rows (never hit)."""
    return sc_layout(wald_rows(clusters), m)


def tri_meta(clusters: Clusters, tri_geometry: torch.Tensor,
             tri_primitive: torch.Tensor) -> torch.Tensor:
    """[C*S_pad, 16] i32 rows addressed by the walk's winner code
    cluster * S_pad + slot: [0:12] the triangle's Wald coefficients (f32
    bits, row order k*3+c), [12:15] (triangle, geometry, primitive), [15]
    zero. One row gather gives the payload ids and what the host needs to
    re-evaluate the winner's exact (t, u, v)."""
    c, s = clusters.tri_index.shape
    sp = s_pad(clusters)
    tri = clusters.tri_index.to(torch.int32)
    safe = torch.clamp_min(tri, 0).long()
    geom = torch.where(tri >= 0, tri_geometry[safe].to(torch.int32), -1)
    prim = torch.where(tri >= 0, tri_primitive[safe].to(torch.int32), 0)
    meta = torch.stack([tri, geom, prim, torch.zeros_like(tri)], dim=-1)
    if sp != s:
        pad = torch.tensor([-1, -1, 0, 0], dtype=torch.int32,
                           device=tri.device).expand(c, sp - s, 4)
        meta = torch.cat([meta, pad], dim=1)
    coeff = wald_rows(clusters)[:, :12, :].permute(0, 2, 1).contiguous()
    return torch.cat([coeff.view(torch.int32), meta], dim=-1).reshape(
        c * sp, 16)


# wald_rows' rows in the walk kernels' lane order: per lane the u,
# v and z outputs' (x, y, z, bias) inputs, one 16-byte vector each
LANE_ROWS = (0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11)


class WalkLanes(NamedTuple):
    """The walk kernels' view of the Wald table: each lane's 12
    coefficients contiguous, and per cluster the lanes it must test."""

    coeffs: torch.Tensor  # [C, S_pad, 12] f32, rows in LANE_ROWS order
    count: torch.Tensor  # [C] i32: 1 + the last lane with a nonzero row


def walk_lanes(wald: torch.Tensor) -> WalkLanes:
    """WalkLanes of a [C, 16, S_pad] Wald table. A lane whose 12 rows are
    all zero has d'_z == 0 and never hits, so a cluster's lanes past
    `count` need no test: the real triangles are a prefix of each cluster
    row and the padding lanes are zero."""
    rows = wald[:, list(LANE_ROWS), :]  # [C, 12, S_pad]
    used = (rows != 0).any(dim=1)  # [C, S_pad]
    lane = torch.arange(1, wald.shape[2] + 1, device=wald.device)
    return WalkLanes(rows.permute(0, 2, 1).contiguous(),
                     (used * lane).amax(dim=1).to(torch.int32))


class WalkTables(NamedTuple):
    """The walk's per-scene tables, built once (make_tracers)."""

    wald_rows: torch.Tensor  # [C, 16, S_pad] f32
    meta_rows: torch.Tensor  # [C*S_pad, 16] i32
    lanes: WalkLanes  # the walk kernels' lane-major copy of wald_rows


def build_tables(clusters: Clusters, tri_geometry, tri_primitive
                 ) -> WalkTables:
    rows = wald_rows(clusters).contiguous()
    return WalkTables(rows, tri_meta(clusters, tri_geometry, tri_primitive),
                      walk_lanes(rows))


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------

def _check_walk_args(rays8, cand_idx, cand_t, cand_count, wald, group):
    if cand_idx.dim() != 2:
        raise ValueError(f"cand_idx must be [B, K], got {tuple(cand_idx.shape)}")
    b, k = cand_idx.shape
    specs = ((rays8, torch.float32, None), (cand_idx, torch.int32, (b, k)),
             (cand_t, torch.float32, (b, k)), (cand_count, torch.int32, (b,)),
             (wald, torch.float32, None))
    for name, (x, dtype, shape) in zip(
            ("rays8", "cand_idx", "cand_t", "cand_count", "wald_rows"), specs):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != rays8.device:
            raise ValueError(f"{name} is on {x.device}, rays8 on {rays8.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rays8.dim() != 2 or rays8.shape[1] != 8 or b == 0 \
            or rays8.shape[0] % b:
        raise ValueError(f"rays8 must be [B*P, 8], got {tuple(rays8.shape)}")
    p = rays8.shape[0] // b
    if wald.dim() != 3 or wald.shape[1] != 16:
        raise ValueError(f"wald_rows must be [C, 16, S_pad], "
                         f"got {tuple(wald.shape)}")
    sp = wald.shape[2]
    if not 1 <= group <= 8 or group * sp > SLOT_MASK + 1:
        raise ValueError(f"group {group} x S_pad {sp} exceeds the "
                         f"{SLOT_BITS}-bit slot field")
    return b, k, p, sp


def knob_instance(*, lean: bool = False, debug_steps: bool = False,
                  depth: int | None = None, mb: int | None = None,
                  mm: bool = False) -> str:
    """The name of a walk's instance under these knobs: "" for the default
    (depth 4, one bundle a block, the code, no steps, the lane test), else
    its knobs, e.g. "depth=1", "mb=2", "lean", "steps", "mm"."""
    if depth is not None and depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS} or None, not {depth}")
    if mb is not None and mb < 1:
        raise ValueError(f"mb must be >= 1 or None, not {mb}")
    parts = [f"depth={depth}"] * (depth not in (None, DEPTH))
    parts += [f"mb={mb}"] * (mb not in (None, 1))
    parts += ["lean"] * lean + ["steps"] * debug_steps + ["mm"] * mm
    return ",".join(parts)


def count_launch(wrapper, instance: str) -> None:
    """One launch of a kernel wrapper's instance: the default's in
    wrapper.launches, the others' in wrapper.knob_launches[instance]."""
    if instance:
        wrapper.knob_launches[instance] = (
            wrapper.knob_launches.get(instance, 0) + 1)
    else:
        wrapper.launches += 1


def _launch(entry, name, rays8, cand_idx, cand_t, cand_count, wald_rows,
            lanes, b, p, k, sp, group, sc_m: int = 0, n_clusters: int = 0,
            *, lean: bool = False, debug_steps: bool = False,
            depth: int | None = None, mb: int | None = None,
            mm: bool = False):
    """Launch one walk kernel of the library (it reads the table as
    `lanes`; sc_m > 0 is a supercluster walk over n_clusters) on the
    current stream; raises if the launch is refused. Returns the output
    rows: ([B*P] i32 out,), under lean (best key, winning step), then with
    debug_steps the [B] i32 steps."""
    if p > MAX_BUNDLE or p % 32:
        raise ValueError(f"bundle size {p} must be a multiple of 32, "
                         f"<= {MAX_BUNDLE}")
    _check_lanes(lanes, wald_rows)
    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    dev = rays8.device
    order = torch.empty(b, dtype=torch.int32, device=dev)
    out = torch.empty(b * p, dtype=torch.int32, device=dev)
    aux = torch.empty(b * p, dtype=torch.int32, device=dev) if lean else None
    steps = torch.empty(b, dtype=torch.int32, device=dev) if debug_steps \
        else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            rays8.data_ptr(), cand_idx.data_ptr(), cand_t.data_ptr(),
            cand_count.data_ptr(), lanes.coeffs.data_ptr(),
            lanes.count.data_ptr(), order.data_ptr(), out.data_ptr(),
            None if aux is None else aux.data_ptr(),
            None if steps is None else steps.data_ptr(), b, p, k, sp, group,
            sc_m, n_clusters, DEPTH if depth is None else depth,
            1 if mb is None else mb, int(mm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    return tuple(x for x in (out, aux, steps) if x is not None)


def _rows(rows: tuple, work=None):
    """A walk's result: its one output row, or the tuple of its rows (lean,
    debug_steps), with the WalkWork beside it where one was counted."""
    out = rows[0] if len(rows) == 1 else rows
    return out if work is None else (out, work)


def _check_lanes(lanes: WalkLanes, wald: torch.Tensor) -> None:
    c, sp = wald.shape[0], wald.shape[2]
    for name, x, dtype, shape in (
            ("lanes.coeffs", lanes.coeffs, torch.float32, (c, sp, 12)),
            ("lanes.count", lanes.count, torch.int32, (c,))):
        if x.dtype != dtype or tuple(x.shape) != shape \
                or x.device != wald.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{wald.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


class WalkWork(NamedTuple):
    """What a walk does on given inputs, as its plain version counts it:
    the steps each bundle takes and the (ray, triangle) Wald tests of all
    of them. Only real triangles count: a cluster's padding lanes and the
    group members past a bundle's candidates are left out, and a ray of
    the any-hit walk counts the triangles of its last step only up to its
    first hit, where the kernel stops it."""

    steps: torch.Tensor  # [B] i64
    ray_lanes: torch.Tensor  # i64 scalar


def _new_work(b: int, dev) -> WalkWork:
    return WalkWork(torch.zeros(b, dtype=torch.int64, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))


def _chunk_bundles(dev, p: int, w: int) -> int:
    """Bundles per chunk of a plain walk (REFERENCE_CHUNK_ELEMS bounds its
    [bundles, P, group*S_pad] temporaries)."""
    return max(1, REFERENCE_CHUNK_ELEMS[dev.type] // (p * w))


def _step_rows(cand_idx, wald_rows, k0: int, group: int):
    """Step k0 of each bundle: its `group` candidate clusters [nb, group]
    (past the list: clamped, the caller masks them) and their Wald rows
    [nb, 12, 1, group*S_pad], cluster g at lanes g*S_pad + lane."""
    nb = cand_idx.shape[0]
    ci = cand_idx[:, k0:k0 + group]
    if ci.shape[1] < group:
        ci = torch.nn.functional.pad(ci, (0, group - ci.shape[1]))
    ci = torch.clamp(ci, 0, wald_rows.shape[0] - 1)
    wr = (wald_rows[ci.long(), :12, :]  # [nb, group, 12, S_pad]
          .permute(0, 2, 1, 3).reshape(nb, 12, 1, -1))
    return ci, wr


def _real_lanes(lane_real, ci, live):
    """[nb, W] bool: the step's lanes that hold a real triangle of a live
    candidate. lane_real [C, S_pad] marks each cluster's real triangles."""
    return lane_real[ci.long()].reshape(live.shape) & live


def walk_closest(rays8, cand_idx, cand_t, cand_count, wald_rows, group, *,
                 lanes: WalkLanes, lean: bool = False,
                 debug_steps: bool = False, depth: int | None = None,
                 mb: int | None = None, mm: bool = False):
    """Closest-hit bundle walk: winner code [B*P] i32 per ray (cluster *
    S_pad + slot, 0x7FFFFFFF on a miss). rays8 [B*P, 8] f32 rows (ox oy oz
    dx dy dz t_min t_max) in bundle order; cand_idx/cand_t [B, K] nearest
    first, cand_count [B]; wald_rows [C, 16, S_pad] and lanes, its
    walk_lanes (WalkTables.lanes).

    The knobs (module docstring): lean returns (best key, winning step,
    -1 on a miss) instead of the code; debug_steps appends each bundle's
    steps [B] i32 (a tuple of the rows either way); depth (1-4) and mb
    shape the launch only; mm tests through the tensor cores.

    A CUDA tensor launches csrc/bundle_walk.cu on the current stream (and
    counts the launch in walk_closest.launches, or under a knob in
    walk_closest.knob_launches[knob_instance(...)]); the kernel reads the
    table as `lanes`. A CPU tensor runs walk_closest_reference on
    wald_rows. Anything else raises."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    knobs = dict(debug_steps=debug_steps, depth=depth, mb=mb, mm=mm)
    inst = knob_instance(lean=lean, **knobs)
    if rays8.device.type == "cpu":
        return walk_closest_reference(rays8, cand_idx, cand_t, cand_count,
                                      wald_rows, group, lean=lean,
                                      debug_steps=debug_steps, mm=mm)
    if rays8.device.type != "cuda":
        raise ValueError(f"walk_closest runs on cuda or cpu, "
                         f"not {rays8.device}")
    rows = _launch("rt2_walk_closest", "walk_closest", rays8, cand_idx,
                   cand_t, cand_count, wald_rows, lanes, b, p, k, sp, group,
                   lean=lean, **knobs)
    count_launch(walk_closest, inst)
    return _rows(rows)


walk_closest.launches = 0
walk_closest.knob_launches = {}


def _sc_walk_args(wald_rows, group, lane_real, sc_m):
    """A plain walk's table, group, S_pad and lane_real in supercluster
    mode (sc_m > 0: candidate s is clusters s*sc_m .. s*sc_m + sc_m - 1,
    one step each): the walk runs over sc_layout(wald_rows, sc_m) with one
    candidate a step, whose lane s*sc_m*S_pad + g*S_pad + lane is JAX's
    SC-mode slot and whose winner code cluster * S_pad + lane is the
    cluster walk's."""
    if group != sc_m:
        raise ValueError(f"a supercluster walk's group {group} must be its "
                         f"sc_m {sc_m}")
    if lane_real is not None:
        lane_real = sc_layout(lane_real[:, None], sc_m)[:, 0]
    return sc_layout(wald_rows, sc_m), 1, lane_real


def walk_closest_reference(rays8, cand_idx, cand_t, cand_count, wald_rows,
                           group, lane_real=None, sc_m: int = 0, *,
                           lean: bool = False, debug_steps: bool = False,
                           mm: bool = False):
    """Plain torch version of the walk, batched over the bundles that step
    (those still walking): the same steps, predicates, packed keys, tie
    rule and early exit as the kernel, with the same Wald test (hit_test),
    so the two agree bit for bit. Given lane_real ([C, S_pad] bool, True on
    a real triangle's lane), it also returns the WalkWork these inputs
    need. sc_m > 0 is the supercluster walk of walk_closest_sc (group ==
    sc_m; _sc_walk_args). lean and debug_steps give walk_closest's rows;
    mm tests with hit_test_mm (float32 matrix products, as JAX's
    _intersect_block_mm), which the kernel's tensor-core form matches only
    up to rounding ties."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    test = hit_test_mm if mm else hit_test
    if sc_m:
        wald_rows, group, lane_real = _sc_walk_args(wald_rows, group,
                                                    lane_real, sc_m)
        sp *= sc_m
    dev = rays8.device
    w = group * sp
    bc = _chunk_bundles(dev, p, w)
    lane = torch.arange(w, device=dev)
    grp = lane // sp
    lane_in = lane % sp
    work = _new_work(b, dev)
    rays = rays8.reshape(b, p, 8)
    best_key = (rays[..., 7].view(torch.int32) & ~SLOT_MASK) | SLOT_MASK
    best_code = torch.full((b, p), MISS_CODE, dtype=torch.int32, device=dev)
    best_it = torch.full((b, p), -1, dtype=torch.int32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for k0 in range(0, int(cand_count.max()), group):
        worst = (best_key | SLOT_MASK).view(torch.float32).amax(dim=1)
        alive &= (k0 < cand_count) & (cand_t[:, k0] <= worst)
        # only the bundles that step are tested, in chunks of bc
        stepping = alive.nonzero().reshape(-1)
        if stepping.numel() == 0:
            break
        work.steps.add_(alive)
        for ids in stepping.split(bc):
            ci, wr = _step_rows(cand_idx[ids, k0:k0 + group], wald_rows, 0,
                                group)
            t, hit = test(rays[ids], wr)
            live = lane[None, :] < (cand_count[ids, None] - k0) * sp
            if lane_real is not None:
                work.ray_lanes.add_(
                    p * _real_lanes(lane_real, ci, live).sum())
            hit &= live[:, None, :]
            key = torch.where(
                hit, (t.view(torch.int32) & ~SLOT_MASK) | lane.to(torch.int32),
                NO_HIT_KEY)
            step_key, arg = key.min(dim=-1)  # [nb, P]
            step_code = (torch.gather(ci, 1, grp[arg].reshape(ids.numel(), -1))
                         .reshape(-1, p) * sp + lane_in[arg])
            key_was = best_key[ids]
            better = step_key < key_was
            best_key[ids] = torch.where(better, step_key, key_was)
            best_code[ids] = torch.where(better, step_code.to(torch.int32),
                                         best_code[ids])
            best_it[ids] = torch.where(better, k0 // group, best_it[ids])
    rows = ((best_key.reshape(b * p), best_it.reshape(b * p)) if lean
            else (best_code.reshape(b * p),))
    if debug_steps:
        rows += (work.steps.to(torch.int32),)
    return _rows(rows, None if lane_real is None else work)


def walk_occluded(rays8, cand_idx, cand_t, cand_count, wald_rows, group, *,
                  lanes: WalkLanes, debug_steps: bool = False,
                  depth: int | None = None, mb: int | None = None,
                  mm: bool = False):
    """Any-hit bundle walk: [B*P] i32 per ray, 1 where a triangle blocks
    the open segment (t_min, t_max), else 0; rays with t_max <= t_min
    (padding) report 0. Arguments and knobs as walk_closest's
    (debug_steps: (blocked, steps)).

    A CUDA tensor launches csrc/bundle_occlude.cu on the current stream
    (and counts the launch in walk_occluded.launches, or under a knob in
    walk_occluded.knob_launches); the kernel reads the table as `lanes`. A
    CPU tensor runs walk_occluded_reference on wald_rows. Anything else
    raises."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    knobs = dict(debug_steps=debug_steps, depth=depth, mb=mb, mm=mm)
    inst = knob_instance(**knobs)
    if rays8.device.type == "cpu":
        return walk_occluded_reference(rays8, cand_idx, cand_t, cand_count,
                                       wald_rows, group,
                                       debug_steps=debug_steps, mm=mm)
    if rays8.device.type != "cuda":
        raise ValueError(f"walk_occluded runs on cuda or cpu, "
                         f"not {rays8.device}")
    rows = _launch("rt2_walk_occluded", "walk_occluded", rays8, cand_idx,
                   cand_t, cand_count, wald_rows, lanes, b, p, k, sp, group,
                   **knobs)
    count_launch(walk_occluded, inst)
    return _rows(rows)


walk_occluded.launches = 0
walk_occluded.knob_launches = {}


def walk_occluded_reference(rays8, cand_idx, cand_t, cand_count, wald_rows,
                            group, lane_real=None, sc_m: int = 0, *,
                            debug_steps: bool = False, mm: bool = False):
    """Plain torch version of the any-hit walk, batched over the bundles
    that step: the same steps, predicates and exits as the kernel (a ray
    is done at its first hit; a bundle stops when every ray is done, its
    candidates run out, or the next entry distance exceeds the largest
    t_max of its live rays, NaN ending the walk), with the kernel's Wald
    test, so the two agree bit for bit. Given lane_real, it also returns the WalkWork, as
    walk_closest_reference does; sc_m > 0 is the supercluster walk of
    walk_occluded_sc; debug_steps and mm as walk_closest_reference's."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    test = hit_test_mm if mm else hit_test
    if sc_m:
        wald_rows, group, lane_real = _sc_walk_args(wald_rows, group,
                                                    lane_real, sc_m)
        sp *= sc_m
    dev = rays8.device
    w = group * sp
    bc = _chunk_bundles(dev, p, w)
    lane = torch.arange(w, device=dev)
    work = _new_work(b, dev)
    rays = rays8.reshape(b, p, 8)
    done = rays[..., 7] <= rays[..., 6]
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for k0 in range(0, int(cand_count.max()), group):
        worst = torch.where(done, -torch.inf, rays[..., 7]).amax(dim=1)
        alive &= (k0 < cand_count) & (cand_t[:, k0] <= worst)
        # only the bundles that step are tested, in chunks of bc
        stepping = alive.nonzero().reshape(-1)
        if stepping.numel() == 0:
            break
        work.steps.add_(alive)
        for ids in stepping.split(bc):
            r = rays[ids]
            ci, wr = _step_rows(cand_idx[ids, k0:k0 + group], wald_rows, 0,
                                group)
            t, hit = test(r, wr)
            live = lane[None, :] < (cand_count[ids, None] - k0) * sp
            hit &= (t < r[..., 7:8]) & live[:, None, :]
            step_hit = hit.any(dim=-1)
            done_was = done[ids]
            if lane_real is not None:
                # real triangles a testing ray tests: up to and including
                # its first hit, else all of the step's
                upto = _real_lanes(lane_real, ci, live).cumsum(dim=-1)
                first = hit.to(torch.uint8).argmax(dim=-1)  # [nb, P]
                tested = torch.where(step_hit, torch.gather(upto, 1, first),
                                     upto[:, -1:])
                work.ray_lanes.add_((tested * ~done_was).sum())
            done[ids] = done_was | step_hit
    rows = ((done & (rays[..., 7] > rays[..., 6])).to(torch.int32)
            .reshape(b * p),)
    if debug_steps:
        rows += (work.steps.to(torch.int32),)
    return _rows(rows, None if lane_real is None else work)


def _walk_sc(wrapper, entry: str, reference, rays8, cand_idx, cand_t,
             cand_count, wald_rows, group, lanes, **knobs):
    """A supercluster walk: the plain version on a CPU tensor, else the
    library's `entry` (sc_m = group), counted in wrapper.launches (or
    under a knob, debug_steps, depth or mb, in wrapper.knob_launches)."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    inst = knob_instance(**knobs)
    if rays8.device.type == "cpu":
        return reference(rays8, cand_idx, cand_t, cand_count, wald_rows,
                         group, sc_m=group, debug_steps=knobs["debug_steps"])
    name = wrapper.__name__
    if rays8.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {rays8.device}")
    rows = _launch(entry, name, rays8, cand_idx, cand_t, cand_count,
                   wald_rows, lanes, b, p, k, sp, group, group,
                   wald_rows.shape[0], **knobs)
    count_launch(wrapper, inst)
    return _rows(rows)


def walk_closest_sc(rays8, cand_idx, cand_t, cand_count, wald_rows, group,
                    *, lanes: WalkLanes, debug_steps: bool = False,
                    depth: int | None = None, mb: int | None = None):
    """Closest-hit walk of supercluster candidates (cull="sc"; JAX's
    _walk_kernel with sc_m = group): candidate s stands for the clusters
    s*group .. s*group + group - 1 (those past C hold nothing), all walked
    in one step, and the early exit is tested before each candidate. The
    winner code is cluster * S_pad + slot, as walk_closest's. Arguments as
    walk_closest's (wald_rows and lanes are the cluster tables), and the
    knobs debug_steps, depth and mb (lean and mm have no supercluster
    form, as in JAX).

    A CUDA tensor launches csrc/bundle_walk.cu's supercluster kernel (and
    counts the launch in walk_closest_sc.launches); a CPU tensor runs
    walk_closest_reference(..., sc_m=group). Anything else raises."""
    return _walk_sc(walk_closest_sc, "rt2_walk_closest",
                    walk_closest_reference, rays8, cand_idx, cand_t,
                    cand_count, wald_rows, group, lanes,
                    debug_steps=debug_steps, depth=depth, mb=mb)


walk_closest_sc.launches = 0
walk_closest_sc.knob_launches = {}


def walk_occluded_sc(rays8, cand_idx, cand_t, cand_count, wald_rows, group,
                     *, lanes: WalkLanes, debug_steps: bool = False,
                     depth: int | None = None, mb: int | None = None):
    """Any-hit walk of supercluster candidates (JAX's _occlude_kernel with
    sc_m = group), as walk_closest_sc is the closest-hit one. A CUDA tensor
    launches csrc/bundle_occlude.cu's supercluster kernel (counted in
    walk_occluded_sc.launches); a CPU tensor runs
    walk_occluded_reference(..., sc_m=group). Knobs as walk_closest_sc's."""
    return _walk_sc(walk_occluded_sc, "rt2_walk_occluded",
                    walk_occluded_reference, rays8, cand_idx, cand_t,
                    cand_count, wald_rows, group, lanes,
                    debug_steps=debug_steps, depth=depth, mb=mb)


walk_occluded_sc.launches = 0
walk_occluded_sc.knob_launches = {}


# ---------------------------------------------------------------------------
# Candidate prep
# ---------------------------------------------------------------------------

def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


SORT_KEYS = ("cand0", "hier", "sc4", "octz", "cand2")
CULLS = ("auto", "exact", "exact_iv", "interval", "hier", "sc")
HIER_KEY_M = 32  # clusters per supercluster of the "hier" sort key
SC4_M = 4  # clusters per supercluster of the "sc4" sort key


def _octant(d: torch.Tensor) -> torch.Tensor:
    return ((d[:, 0] >= 0).long() | ((d[:, 1] >= 0).long() << 1)
            | ((d[:, 2] >= 0).long() << 2))


def _t_bucket(tx, scene_min, scene_max) -> torch.Tensor:
    """clip(uint32(4 t_max / |scene diagonal|), 0, 3); dead lanes carry
    t_max = -1: clamp BEFORE the integer conversion (the JAX uint32 cast of
    a negative float saturates to 0)."""
    diag = _norm3(scene_max - scene_min)
    return torch.clamp(4.0 * tx / torch.clamp_min(diag, 1e-12),
                       0.0, 3.0).long()


def _tie_key(cand0, c: int, o, d, tx, scene_min, scene_max) -> torch.Tensor:
    """[cand0 | t_max bucket | octant | 15-bit origin Morton] in 32 bits,
    the tiebreak of the cand0 and hier keys: short rays bundle together,
    then direction octant and origin Morton for coherence."""
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    q = torch.clamp((o - scene_min) / extent, 0.0, 0.999)
    ocell = (q * 32.0).long()
    o_morton = (_expand_bits(ocell[:, 0], 5)
                | (_expand_bits(ocell[:, 1], 5) << 1)
                | (_expand_bits(ocell[:, 2], 5) << 2))
    tie = ((_t_bucket(tx, scene_min, scene_max) << 18) | (_octant(d) << 15)
           | o_morton)  # 20 bits
    bits_c = max((c + 1).bit_length(), 1)
    tie_bits = max(32 - bits_c, 0)
    if tie_bits >= 20:
        tie_part = tie << (tie_bits - 20)
    else:
        tie_part = tie >> (20 - tie_bits)
    return ((cand0 << tie_bits) | tie_part) & 0xFFFFFFFF


def cand0_sort_key(rays8, amin, amax, scene_min, scene_max):
    """Per-ray sort key of [N, 8] ray rows (int64 holding uint32): [nearest
    exactly-overlapped box id | t_max bucket | octant | origin Morton]. Rays
    that touch nothing key to C and compact into empty bundles. The boxes
    are cluster boxes (the cand0 key) or supercluster boxes (sc4)."""
    cand0 = cull_mod.nearest_box(rays8, amin, amax).long()
    return _tie_key(cand0, amin.shape[0], rays8[:, 0:3], rays8[:, 3:6],
                    rays8[:, 7], scene_min, scene_max)


def octz_sort_key(d, tx, scene_min, scene_max):
    """Key without a dense pass, for batches whose arrival order is
    already coherent (visibility rays in pixel Z-order): direction octant
    | t_max bucket | arrival rank (JAX _octz_sort_key)."""
    rank = torch.arange(d.shape[0], device=d.device) & ((1 << 27) - 1)
    return ((_octant(d) << 29) | (_t_bucket(tx, scene_min, scene_max) << 27)
            | rank)


def supercluster_boxes(clusters: Clusters, m: int):
    """Boxes of m consecutive clusters [ceil(C/m), 3] (JAX
    _supercluster_boxes); the clusters padding C to whole superclusters
    carry never-hit boxes (1e30 / -1e30) that vanish in the union."""
    c = clusters.num_clusters
    sc = (c + m - 1) // m
    pad = sc * m - c
    amin = torch.nn.functional.pad(clusters.aabb_min, (0, 0, 0, pad),
                                   value=1e30)
    amax = torch.nn.functional.pad(clusters.aabb_max, (0, 0, 0, pad),
                                   value=-1e30)
    return amin.reshape(sc, m, 3).amin(1), amax.reshape(sc, m, 3).amax(1)


def _entry_exact_rows(o, d, tn, tx, amin, amax):
    """Slab test of rays o, d [..., 3] (tn, tx [...]) against per-ray box
    rows amin, amax [..., K, 3] that broadcast against them: [..., K]
    entry distances, +inf on a miss (JAX _entry_exact_rows, and the refine
    of _prepare_bundles_hier)."""
    eps = 1e-12
    ds = torch.where(torch.abs(d) < eps, torch.where(d >= 0, eps, -eps), d)
    inv = (1.0 / ds)[..., None, :]
    o = o[..., None, :]
    near = far = None
    for ax in range(3):
        t0 = (amin[..., ax] - o[..., ax]) * inv[..., ax]
        t1 = (amax[..., ax] - o[..., ax]) * inv[..., ax]
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    tn, tx = tn[..., None], tx[..., None]
    hit = (near <= far) & (far >= tn) & (near <= tx) & (tx >= 0.0)
    return torch.where(hit, torch.where(near > 0.0, near, 0.0), torch.inf)


def _ray_chunk(dev, per_ray_bytes: int) -> int:
    """Rays per chunk of a plain pass whose temporaries take per_ray_bytes
    a ray (a multiple of 1024, as JAX chunks its key passes)."""
    return max(1024, cull_mod.chunk_bytes(dev) // max(per_ray_bytes, 1)
               // 1024 * 1024)


def hier_sort_key(rays8, clusters: Clusters, sc_min, sc_max, m: int,
                  scene_min, scene_max):
    """Cluster-granularity key without the dense [N, C] pass (JAX
    _hier_sort_key): each ray's nearest supercluster (B3 over the [SC]
    boxes), then its nearest cluster among that supercluster's m; a ray
    that overlaps the supercluster box but none of its clusters keys to the
    supercluster's first cluster, one that overlaps nothing to C. Then the
    cand0 key's tiebreak."""
    c = clusters.num_clusters
    n_sc = sc_min.shape[0]
    nearest = cull_mod.nearest_box(rays8, sc_min, sc_max).long()
    any_sc = nearest < n_sc
    sc0 = torch.where(any_sc, nearest, 0)
    members = torch.arange(m, device=rays8.device)
    cand0 = torch.empty_like(sc0)
    chunk = _ray_chunk(rays8.device, 4 * 12 * m)
    for s in range(0, rays8.shape[0], chunk):
        r = rays8[s:s + chunk]
        first = sc0[s:s + chunk] * m
        cl = torch.clamp_max(first[:, None] + members, c - 1)
        e_cl = _entry_exact_rows(r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7],
                                 clusters.aabb_min[cl], clusters.aabb_max[cl])
        near, local = e_cl.min(dim=-1)  # first index among ties
        cand0[s:s + chunk] = torch.where(torch.isfinite(near), first + local,
                                         first)
    cand0 = torch.where(any_sc, cand0, c)
    return _tie_key(cand0, c, rays8[:, 0:3], rays8[:, 3:6], rays8[:, 7],
                    scene_min, scene_max)


def cand2_sort_key(rays8, amin, amax, scene_min, scene_max):
    """The nearest two exactly-overlapped clusters (JAX _cand2_sort_key):
    [id0 | octant | id1 | 5-bit coarse origin Morton], or [id0 | octant |
    Morton] where 2 ids and 8 bits do not fit in 32. The two nearest come
    from a plain dense pass (the nearest, then the nearest of the rest:
    jax.lax.top_k(-e, 2) with its lower-index ties)."""
    n, c = rays8.shape[0], amin.shape[0]
    id0 = torch.empty(n, dtype=torch.int64, device=rays8.device)
    id1 = torch.empty_like(id0)
    chunk = _ray_chunk(rays8.device, 4 * 4 * c)
    for s in range(0, n, chunk):
        r = rays8[s:s + chunk]
        e = cull_mod._entry_exact(r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7],
                                  amin, amax)
        t0, i0 = e.min(dim=-1)
        e.scatter_(1, i0[:, None], torch.inf)
        t1, i1 = e.min(dim=-1)
        id0[s:s + chunk] = torch.where(torch.isfinite(t0), i0, c)
        id1[s:s + chunk] = torch.where(torch.isfinite(t1), i1, c)
    o, d = rays8[:, 0:3], rays8[:, 3:6]
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    q = torch.clamp((o - scene_min) / extent, 0.0, 0.999)
    ocell = (q * 4.0).long()  # 2 bits per axis -> 6, keep 5
    o_morton = (_expand_bits(ocell[:, 0], 2)
                | (_expand_bits(ocell[:, 1], 2) << 1)
                | (_expand_bits(ocell[:, 2], 2) << 2)) & 0x1F
    octant = _octant(d)
    # id0 | OCTANT | id1 | morton: the octant outranks id1, so rays sharing
    # their nearest cluster but pointing opposite ways do not bundle
    bits_c = max((c + 1).bit_length(), 1)
    if 2 * bits_c + 8 > 32:
        key = (id0 << 8) | (octant << 5) | o_morton
    else:
        shift_oct = 5 + bits_c
        key = ((id0 << (shift_oct + 3)) | (octant << shift_oct)
               | (id1 << 5) | o_morton)
    return key & 0xFFFFFFFF


def exact_sort_key(name: str, clusters: Clusters, rays8, scene_min,
                   scene_max):
    """The exact cull's sort key `name` (SORT_KEYS) of [N, 8] ray rows."""
    if name == "cand0":
        return cand0_sort_key(rays8, clusters.aabb_min, clusters.aabb_max,
                              scene_min, scene_max)
    if name == "sc4":
        # cand0 at 4-cluster supercluster granularity: 1/4 of the dense
        # key pass; only bundle composition changes, not the cull
        sc_min, sc_max = supercluster_boxes(clusters, SC4_M)
        return cand0_sort_key(rays8, sc_min, sc_max, scene_min, scene_max)
    if name == "hier":
        sc_min, sc_max = supercluster_boxes(clusters, HIER_KEY_M)
        return hier_sort_key(rays8, clusters, sc_min, sc_max, HIER_KEY_M,
                             scene_min, scene_max)
    if name == "octz":
        return octz_sort_key(rays8[:, 3:6], rays8[:, 7], scene_min,
                             scene_max)
    if name == "cand2":
        return cand2_sort_key(rays8, clusters.aabb_min, clusters.aabb_max,
                              scene_min, scene_max)
    raise ValueError(f"sort_key must be one of {SORT_KEYS}, not {name!r}")


class Prep(NamedTuple):
    """Bundled rays and their candidate lists. Rays are in bundle order
    (perm maps bundle row -> caller row; None when presorted) and padded
    to whole bundles; candidate arrays are [B, k] nearest first. sc_m > 0:
    the candidates are ids of superclusters of sc_m clusters (cull="sc")."""

    perm: torch.Tensor | None
    o: torch.Tensor
    d: torch.Tensor
    tn: torch.Tensor
    tx: torch.Tensor
    cand_idx: torch.Tensor  # [B, k] i32
    cand_t: torch.Tensor  # [B, k] f32 entry distances (+inf past the union)
    cand_count: torch.Tensor  # [B] i32
    overflowed: torch.Tensor  # [B] bool: union larger than k
    sc_m: int = 0


def _rank(entry: torch.Tensor, k: int):
    """Nearest-first candidates of [B, C] entry distances: stable argsort
    and the first k (ties to the lower index, as jax.lax.top_k)."""
    idx = torch.argsort(entry, dim=-1, stable=True)[:, :k]
    cand_t = torch.gather(entry, 1, idx)
    n_union = torch.isfinite(entry).sum(dim=-1)
    cand_count = torch.minimum(torch.isfinite(cand_t).sum(dim=-1), n_union)
    return idx.to(torch.int32), cand_t, cand_count.to(torch.int32), n_union > k


def _finish(perm, o, d, tn, tx, parts, sc_m: int = 0) -> Prep:
    idx, ct, cnt, ovf = (torch.cat(x) for x in zip(*parts))
    return Prep(perm, o, d, tn, tx, idx.contiguous(), ct.contiguous(),
                cnt.contiguous(), ovf, sc_m)


def _apply_sort(rays8, key):
    """The rays in key order (a stable argsort, as jnp.argsort): (perm, o,
    d, tn, tx), perm mapping sorted row -> caller row."""
    perm = torch.argsort(key, stable=True)
    packed = rays8[perm]
    return perm, packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7]


def _ordered(origins, directions, t_min, t_max, key_of=None):
    """(perm, o, d, tn, tx): the rays as they came (key_of None: presorted,
    perm None) or sorted by key_of([N, 8] ray rows)."""
    if key_of is None:
        return None, origins, directions, t_min, t_max
    rays8 = _pack8(origins, directions, t_min, t_max)
    return _apply_sort(rays8, key_of(rays8))


def _sorted(clusters: Clusters, origins, directions, t_min, t_max,
            scene_min, scene_max, key: str):
    """The rays sorted by the exact cull's key `key` (exact_sort_key)."""
    return _ordered(origins, directions, t_min, t_max, lambda r:
                    exact_sort_key(key, clusters, r, scene_min, scene_max))


def _rank_chunks(entry: torch.Tensor, k: int):
    """_rank over chunks of bundles: the stable argsort's [bundles, C] i64
    temporaries stay under the cull's chunk bound."""
    c = entry.shape[1]
    cb = max(1, cull_mod.chunk_bytes(entry.device) // (8 * max(c, 1)))
    return [_rank(entry[b0:b0 + cb], k) for b0 in range(0, entry.shape[0], cb)]


def apply_t_cap(tx: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """min(t_max, max(cap * 1.0001 + 1e-6, -1)) (JAX _apply_t_cap): the
    cap inflated by a relative epsilon so boundary hits survive, and rays
    that overlap nothing (cap -inf) clamped to the dead-ray -1, not to a
    NaN key. XLA's CPU backend contracts the multiply-add into one fused
    rounding (checked on the jitted function), so it is fma here."""
    inflated = fma(cap, torch.full_like(cap, 1.0001),
                   torch.full_like(cap, 1e-6))
    return torch.minimum(tx, torch.maximum(inflated,
                                           torch.full_like(cap, -1.0)))


def prepare_bundles_exact(clusters: Clusters, origins, directions, t_min,
                          t_max, scene_min, scene_max, bundle_size: int,
                          presorted: bool, k_cand: int,
                          sort_key: str = "cand0",
                          t_cap: bool = False) -> Prep:
    """Exact-cull prep (JAX _prepare_bundles_exact): per-ray slab tests,
    the rays sorted by `sort_key` (unless presorted), per-bundle union
    candidate lists ranked nearest first. t_cap: each ray's t_max is then
    clamped to the farthest exit of the boxes it overlaps (B4's cap,
    apply_t_cap); the union and the sort key read the t_max given."""
    p = bundle_size
    c = clusters.num_clusters
    if presorted:
        perm, o, d, tn, tx = _ordered(origins, directions, t_min, t_max)
    else:
        perm, o, d, tn, tx = _sorted(clusters, origins, directions, t_min,
                                     t_max, scene_min, scene_max, sort_key)
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    union = cull_mod.bundle_union(_pack8(o, d, tn, tx), clusters.aabb_min,
                                  clusters.aabb_max, p, cap=t_cap)
    if t_cap:
        union, cap = union
        tx = apply_t_cap(tx, cap)
    return _finish(perm, o, d, tn, tx, _rank_chunks(union, min(k_cand, c)))


def prepare_bundles_interval(clusters: Clusters, origins, directions, t_min,
                             t_max, bundle_size: int, k_cand: int,
                             presorted: bool = True, scene_min=None,
                             scene_max=None, exact_key: bool = False,
                             sort_key: str = "cand0") -> Prep:
    """Interval-union prep (JAX _prepare_bundles): per-bundle candidates
    from the conservative interval slab test over all clusters, ranked
    nearest first. Unless presorted the rays are sorted first: by the cand0
    key with exact_key=True (cull="exact_iv"), by octz_sort_key with
    sort_key="octz", else by the coherence key
    (traverse_bundle.sort_rays_for_coherence)."""
    p = bundle_size
    c = clusters.num_clusters
    if presorted:
        perm, o, d, tn, tx = _ordered(origins, directions, t_min, t_max)
    elif exact_key or sort_key == "octz":
        perm, o, d, tn, tx = _sorted(clusters, origins, directions, t_min,
                                     t_max, scene_min, scene_max,
                                     "cand0" if exact_key else "octz")
    else:
        perm = tb.sort_rays_for_coherence(origins, directions, scene_min,
                                          scene_max)
        o, d, tn, tx = (x[perm] for x in (origins, directions, t_min, t_max))
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    k = min(k_cand, c)
    b = o.shape[0] // p
    o_min, o_max, inv_lo, inv_hi, bundle_tmax = _bundle_bounds(o, d, tx, p)
    # ~12 live [bundles, C, 3] f32 temporaries per chunk
    cb = max(1, cull_mod.chunk_bytes(o.device) // (4 * 3 * 12 * max(c, 1)))
    parts = []
    for b0 in range(0, b, cb):
        sl = slice(b0, b0 + cb)
        may_hit, t_enter = bundle_cluster_overlap(
            o_min[sl], o_max[sl], inv_lo[sl], inv_hi[sl], bundle_tmax[sl],
            clusters.aabb_min, clusters.aabb_max)
        entry = torch.where(may_hit, torch.clamp_min(t_enter, 0.0),
                            torch.inf)
        parts.append(_rank(entry, k))
    return _finish(perm, o, d, tn, tx, parts)


def prepare_bundles_hier(clusters: Clusters, origins, directions, t_min,
                         t_max, scene_min, scene_max, bundle_size: int,
                         presorted: bool, k_cand: int, m_super: int,
                         k_sc: int) -> Prep:
    """Two-level exact cull (JAX _prepare_bundles_hier): the union over
    each bundle's rays of the exact entries into C/m_super supercluster
    boxes (B4 over those boxes), its k_sc nearest superclusters, then the
    exact per-ray entries of their clusters, unioned per bundle and ranked
    nearest first. A bundle overflows where its union exceeds k_cand or it
    overlaps more than k_sc superclusters (sc_dropped): the fallback then
    makes it exact. The last supercluster's members past C repeat cluster
    C - 1, as in JAX."""
    p = bundle_size
    c = clusters.num_clusters
    sc_min, sc_max = supercluster_boxes(clusters, m_super)
    n_sc = sc_min.shape[0]
    k_sc = min(k_sc, n_sc)
    kk = k_sc * m_super
    perm, o, d, tn, tx = _ordered(
        origins, directions, t_min, t_max, None if presorted else
        lambda r: hier_sort_key(r, clusters, sc_min, sc_max, m_super,
                                scene_min, scene_max))
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    b = o.shape[0] // p
    k = min(k_cand, kk)
    ue_sc = cull_mod.bundle_union(_pack8(o, d, tn, tx), sc_min, sc_max, p)
    members = torch.arange(m_super, device=o.device)
    # ~8 live [bundles, P, kk] temporaries per chunk
    cb = max(1, cull_mod.chunk_bytes(o.device) // (4 * 8 * max(kk, n_sc) * p))
    parts = []
    for b0 in range(0, b, cb):
        ue = ue_sc[b0:b0 + cb]
        nb = ue.shape[0]
        sc_idx = torch.argsort(ue, dim=-1, stable=True)[:, :k_sc]
        sc_ok = torch.isfinite(torch.gather(ue, 1, sc_idx))  # [nb, k_sc]
        sc_dropped = torch.isfinite(ue).sum(dim=-1) > k_sc
        cl = torch.clamp_max((sc_idx[:, :, None] * m_super + members)
                             .reshape(nb, kk), c - 1)
        rows = slice(b0 * p, (b0 + nb) * p)
        e = _entry_exact_rows(
            o[rows].reshape(nb, p, 3), d[rows].reshape(nb, p, 3),
            tn[rows].reshape(nb, p), tx[rows].reshape(nb, p),
            clusters.aabb_min[cl][:, None], clusters.aabb_max[cl][:, None])
        # clusters of unselected (inf-entry) superclusters: masked
        ok = sc_ok.repeat_interleave(m_super, dim=1)[:, None, :]
        union = torch.where(ok, e, torch.inf).amin(dim=1)  # [nb, kk]
        idx, cand_t, cnt, ovf = _rank(union, k)
        parts.append((torch.gather(cl, 1, idx.long()).to(torch.int32),
                      cand_t, cnt, ovf | sc_dropped))
    return _finish(perm, o, d, tn, tx, parts)


def prepare_bundles_sc(clusters: Clusters, origins, directions, t_min,
                       t_max, scene_min, scene_max, bundle_size: int,
                       presorted: bool, m_super: int) -> Prep:
    """Supercluster-walk prep (JAX _prepare_bundles_sc): the rays sorted
    by the hier key at m_super (unless presorted), each bundle's union of
    exact entries into the ceil(C/m_super) supercluster boxes (B4 over
    them), ranked nearest first at full length: no truncation, so nothing
    overflows. Candidates are supercluster ids (Prep.sc_m = m_super)."""
    p = bundle_size
    sc_min, sc_max = supercluster_boxes(clusters, m_super)
    perm, o, d, tn, tx = _ordered(
        origins, directions, t_min, t_max, None if presorted else
        lambda r: hier_sort_key(r, clusters, sc_min, sc_max, m_super,
                                scene_min, scene_max))
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    union = cull_mod.bundle_union(_pack8(o, d, tn, tx), sc_min, sc_max, p)
    return _finish(perm, o, d, tn, tx,
                   _rank_chunks(union, sc_min.shape[0]), sc_m=m_super)


# ---------------------------------------------------------------------------
# Closest hit
# ---------------------------------------------------------------------------

def _decode(code, meta_rows, on, dn, t_max_orig) -> HitRecord:
    """Winner code -> payload ids via one meta-row gather, then the 12-term
    re-evaluation of the winner's exact (t, u, v) in the caller's order."""
    missed = code == MISS_CODE
    meta = meta_rows[torch.where(missed, 0, code).long()]  # [n, 16] i32
    tri_r = torch.where(missed, -1, meta[:, 12])
    geom_r = torch.where(missed, -1, meta[:, 13])
    prim_r = torch.where(missed, 0, meta[:, 14])

    # XLA contracts these affines into fused multiply-adds, which torch's
    # elementwise ops do not offer; fma rounds each of them once, as XLA
    # does, in XLA's order, so (t, u, v) equal the JAX package's bit for bit
    wf = meta[:, 0:12].contiguous().view(torch.float32)

    def affine(r, x, bias=None):
        # ((w_r x0 + w_r+3 x1) + w_r+6 x2) [+ bias] as XLA fuses it
        acc = fma(wf[:, r + 6], x[:, 2],
                  fma(wf[:, r], x[:, 0], wf[:, r + 3] * x[:, 1]))
        return acc if bias is None else acc + wf[:, bias]

    op_u, op_v, op_z = (affine(r, on, r + 9) for r in range(3))
    dp_u, dp_v, dzv = (affine(r, dn) for r in range(3))
    t_r = -op_z / torch.where(dzv == 0.0, 1.0, dzv)
    u_r = fma(t_r, dp_u, op_u)
    v_r = fma(t_r, dp_v, op_v)
    missed_r = tri_r < 0

    return HitRecord(
        t=torch.where(missed_r, t_max_orig, t_r),
        u=torch.where(missed_r, 0.0, u_r),
        v=torch.where(missed_r, 0.0, v_r),
        geometry_index=torch.where(missed_r, INVALID_INDEX, geom_r.long()),
        primitive_id=torch.where(missed_r, 0, prim_r.long()),
        triangle_index=tri_r)


def _check_decode_args(code, perm, meta_rows, origins, directions,
                       t_max_orig) -> int:
    if code.dim() != 1:
        raise ValueError(f"code must be [N], got {tuple(code.shape)}")
    n = code.shape[0]
    specs = (("code", code, torch.int32, (n,)),
             ("perm", perm, torch.int64, (n,)),
             ("meta_rows", meta_rows, torch.int32, (meta_rows.shape[0], 16)),
             ("origins", origins, torch.float32, (n, 3)),
             ("directions", directions, torch.float32, (n, 3)),
             ("t_max_orig", t_max_orig, torch.float32, (n,)))
    for name, x, dtype, shape in specs:
        if x is None:
            continue
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != code.device:
            raise ValueError(f"{name} is on {x.device}, code on {code.device}")
    if not meta_rows.is_contiguous() or meta_rows.data_ptr() % 16:
        raise ValueError("meta_rows must be contiguous and 16-byte aligned")
    return n


def hit_decode(code, perm, meta_rows, origins, directions,
               t_max_orig) -> HitRecord:
    """The walk's winner codes [N] i32 (bundle order) -> HitRecord in the
    caller's order: perm [N] i64 maps bundle row -> caller row (None: the
    same order); meta_rows is WalkTables.meta_rows (or the pair scene's);
    origins, directions [N, 3], and t_max_orig [N] (a miss's t) are the
    caller's.

    A CUDA tensor launches csrc/hit_decode.cu on the current stream (one
    launch, counted in the profiler counter trace.decode.kernel); a CPU
    tensor runs hit_decode_reference (counted in trace.decode.plain).
    Anything else raises. Both give the same bits. An empty batch returns
    an empty record and counts nothing."""
    n = _check_decode_args(code, perm, meta_rows, origins, directions,
                           t_max_orig)
    if code.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hit_decode runs on cuda or cpu, not {code.device}")
    if n == 0 or code.device.type == "cpu":
        if n:
            count("trace.decode.plain")
        return hit_decode_reference(code, perm, meta_rows, origins,
                                    directions, t_max_orig)
    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    dev = code.device
    ins = [x.contiguous() for x in (code, origins, directions, t_max_orig)]
    perm = None if perm is None else perm.contiguous()
    f32 = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)]
    i64 = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt2_hit_decode(
            ins[0].data_ptr(), None if perm is None else perm.data_ptr(),
            meta_rows.data_ptr(), meta_rows.shape[0],
            *(x.data_ptr() for x in ins[1:]),
            *(x.data_ptr() for x in (*f32, *i64, tri)), n,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"hit_decode launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    count("trace.decode.kernel")
    return HitRecord(*f32, *i64, tri)


def hit_decode_reference(code, perm, meta_rows, origins, directions,
                         t_max_orig) -> HitRecord:
    """Plain torch version of hit_decode: the codes un-sorted with one
    scatter, then _decode in the caller's order."""
    return _decode(_unsort(code, perm), meta_rows, origins, directions,
                   t_max_orig)


M_SUPER = 32  # JAX's m_super: clusters per supercluster of "hier" / "sc"
K_SC = 12  # JAX's k_sc: superclusters each bundle refines under "hier"


def _prepare(clusters: Clusters, origins, directions, tn_o, tx_o,
             scene_min, scene_max, p: int, presorted: bool, cull: str,
             k_cand: int, sort_key: str = "cand0", m_super: int = M_SUPER,
             k_sc: int = K_SC, t_cap: bool = False) -> Prep:
    """JAX's _prep dispatch over the culls (module docstring); "auto" is
    "exact". For "sc" m_super is the caller's, clamped to the walk's
    slot field. t_cap applies to the exact cull only, as in JAX."""
    if cull == "auto":
        cull = "exact"
    if cull == "sc":
        return prepare_bundles_sc(clusters, origins, directions, tn_o, tx_o,
                                  scene_min, scene_max, p, presorted,
                                  m_super)
    if cull == "hier":
        return prepare_bundles_hier(clusters, origins, directions, tn_o,
                                    tx_o, scene_min, scene_max, p, presorted,
                                    k_cand, m_super, k_sc)
    if cull == "exact":
        return prepare_bundles_exact(clusters, origins, directions, tn_o,
                                     tx_o, scene_min, scene_max, p,
                                     presorted, k_cand, sort_key=sort_key,
                                     t_cap=t_cap)
    if cull in ("interval", "exact_iv"):
        return prepare_bundles_interval(
            clusters, origins, directions, tn_o, tx_o, p, k_cand,
            presorted=presorted, scene_min=scene_min, scene_max=scene_max,
            exact_key=cull == "exact_iv", sort_key=sort_key)
    raise ValueError(f"cull must be one of {CULLS}, not {cull!r}")


def _pack8(o, d, tn, tx) -> torch.Tensor:
    """[N, 8] f32 ray rows (ox oy oz dx dy dz t_min t_max)."""
    return torch.cat([o, d, tn[:, None], tx[:, None]], dim=1).contiguous()


def _rays8(prep: Prep) -> torch.Tensor:
    return _pack8(prep.o, prep.d, prep.tn, prep.tx)


def _overflowed_rays(prep: Prep, p: int, n_orig: int) -> torch.Tensor:
    """Caller rows of the rays of the bundles whose union overflowed, in
    their bundle order: two host reads (the bundles, then the rows short
    of the padding)."""
    bidx = readback.nonzero(prep.overflowed, "overflow_rays")
    j = (bidx[:, None] * p + torch.arange(p, device=bidx.device)).reshape(-1)
    j = readback.masked(j, j < n_orig, "overflow_rays")
    return prep.perm[j] if prep.perm is not None else j


def _walk_shape(tables: WalkTables, cull: str, group: int, m_super: int):
    """(group, m_super) as the walks take them: group clamped to the
    SLOT_BITS slot field, and under cull="sc" m_super clamped the same way
    and the group forced to it (one supercluster a step)."""
    cap = (1 << SLOT_BITS) // tables.wald_rows.shape[-1]
    if cull == "sc":
        m = max(1, min(m_super, cap))
        return m, m
    return max(1, min(group, cap)), m_super


def _full_cull(cull: str) -> str:
    """The cull of a whole-batch re-trace at k_cand = C: "hier" would still
    drop superclusters past k_sc, so it re-traces with the exact cull."""
    return "exact" if cull == "hier" else cull


def _lean_code(key, it, prep: Prep, group: int, sp: int, p: int):
    """lean's winner code in bundle order (JAX's sorted-space decode): the
    slot rides the key's low bits, the step gives the candidate, and one
    gather into the candidate table the cluster; -1 steps miss. The
    gather index is clamped into the table, as JAX's jnp.clip (a torch
    gather out of range would raise, or assert on CUDA)."""
    slot = key & SLOT_MASK
    k = prep.cand_idx.shape[1]
    row = torch.arange(key.shape[0], device=key.device) // p
    flat = torch.clamp(row * k + it * group + slot // sp, 0,
                       prep.cand_idx.numel() - 1)
    ci = prep.cand_idx.reshape(-1)[flat]
    return torch.where(it < 0, MISS_CODE, ci * sp + slot % sp)


def _debug_info(steps, prep: Prep) -> dict:
    """debug_steps's telemetry (JAX's): each bundle's walk steps, its
    candidate count and whether any bundle overflowed."""
    return {"steps": steps, "cand_count": prep.cand_count,
            "overflowed": prep.overflowed.any()}


def closest_hit_bundle(clusters: Clusters, tables: WalkTables,
                       origins: torch.Tensor, directions: torch.Tensor,
                       t_min, t_max, scene_min: torch.Tensor,
                       scene_max: torch.Tensor, *, bundle_size: int = 128,
                       presorted: bool = False, cull: str = "exact",
                       group: int = 4, k_cand: int = 256,
                       sort_key: str = "cand0", m_super: int = M_SUPER,
                       k_sc: int = K_SC, overflow_fallback: bool = True,
                       depth: int | None = None, mb: int | None = None,
                       mm: bool = False, t_cap: bool = False,
                       debug_steps: bool = False, lean: bool = False):
    """Closest hit through the bundle walk. Returns (HitRecord, number of
    bundles that overflowed k_cand and took the fallback).

    cull is one of CULLS (module docstring); sort_key (SORT_KEYS) orders
    unsorted rays under "exact" (and "octz" the interval cull's); m_super
    and k_sc shape "hier" and "sc". Under "sc" the walk is walk_closest_sc
    and nothing overflows. The knobs depth, mb, mm, t_cap, lean and
    debug_steps are JAX's (module docstring): depth=None is the card's
    ring of 4 slots (JAX's TPU default is 2 DMA slots), mb=None one bundle
    a block (JAX's TPU default of 8 bundles a grid step is a grid shape).
    debug_steps returns (HitRecord, {"steps", "cand_count",
    "overflowed"}) and takes no fallback. The partial fallback takes
    depth, mb and lean, not mm or t_cap, as JAX's.

    The parts run inside utils/profiler spans: trace.prep (_prepare and
    the walk's ray rows), trace.walk, trace.decode (hit_decode) and
    trace.fallback (the whole re-trace, whose own spans nest in it). The
    overflow count is one counted host read (utils/readback.py, site
    overflow_count) between the prep and the walk, the partial fallback's
    rows two more (overflow_rays)."""
    n_orig = origins.shape[0]
    p = bundle_size
    group, m_super = _walk_shape(tables, cull, group, m_super)
    if cull == "sc":  # no supercluster form, as in JAX
        mm = lean = False
    with span("trace.prep"):
        tn_o = _per_ray(t_min, n_orig, origins)
        tx_o = _per_ray(t_max, n_orig, origins)
        prep = _prepare(clusters, origins, directions, tn_o, tx_o, scene_min,
                        scene_max, p, presorted, cull, k_cand, sort_key,
                        m_super, k_sc, t_cap=t_cap)
        rays8 = _rays8(prep)
    # the overflow count is read before the walk is queued: the host waits
    # for the prep alone, and the walk and the decode run on the card while
    # the host goes on to what follows the trace
    n_ovf = None if debug_steps else readback.item(prep.overflowed.sum(),
                                                   "overflow_count")
    knobs = dict(debug_steps=debug_steps, depth=depth, mb=mb)
    with span("trace.walk"):
        if prep.sc_m:
            rows = walk_closest_sc(rays8, prep.cand_idx, prep.cand_t,
                                   prep.cand_count, tables.wald_rows, group,
                                   lanes=tables.lanes, **knobs)
        else:
            rows = walk_closest(rays8, prep.cand_idx, prep.cand_t,
                                prep.cand_count, tables.wald_rows, group,
                                lanes=tables.lanes, lean=lean, mm=mm,
                                **knobs)
    rows = rows if isinstance(rows, tuple) else (rows,)
    with span("trace.decode"):
        if lean:
            code = _lean_code(rows[0], rows[1], prep, group,
                              tables.wald_rows.shape[-1], p)
        else:
            code = rows[0]
        # the codes to caller order, decoded there (the miss t is the
        # caller's t_max, not the capped one)
        rec = hit_decode(code[:n_orig], prep.perm, tables.meta_rows,
                         origins, directions, tx_o)
    if debug_steps:
        return rec, _debug_info(rows[-1], prep)
    if not overflow_fallback or n_ovf == 0:
        return rec, n_ovf
    with span("trace.fallback"):
        full_k = clusters.num_clusters
        knobs = dict(depth=depth, mb=mb, lean=lean)
        if n_ovf > FALLBACK_BUNDLES:
            rec, _ = closest_hit_bundle(
                clusters, tables, origins, directions, tn_o, tx_o, scene_min,
                scene_max, bundle_size=p, presorted=presorted,
                cull=_full_cull(cull), group=group, k_cand=full_k,
                sort_key=sort_key, overflow_fallback=False, **knobs)
            return rec, n_ovf
        # re-trace only the overflowed bundles' rays, in their bundle order,
        # with full-length candidate lists (cannot truncate => exact)
        oi = _overflowed_rays(prep, p, n_orig)
        sub, _ = closest_hit_bundle(
            clusters, tables, origins[oi], directions[oi], tn_o[oi],
            tx_o[oi], scene_min, scene_max, bundle_size=p, presorted=True,
            cull="exact", group=group, k_cand=full_k,
            overflow_fallback=False, **knobs)
        rec = HitRecord(*(field.index_put((oi,), sub_field)
                          for field, sub_field in zip(rec, sub)))
    return rec, n_ovf


# ---------------------------------------------------------------------------
# Any hit
# ---------------------------------------------------------------------------

def occluded_bundle(clusters: Clusters, tables: WalkTables,
                    origins: torch.Tensor, directions: torch.Tensor,
                    t_min, t_max, scene_min: torch.Tensor,
                    scene_max: torch.Tensor, *, bundle_size: int = 128,
                    presorted: bool = False, cull: str = "exact",
                    group: int = 4, k_cand: int = 256,
                    sort_key: str = "cand0", m_super: int = M_SUPER,
                    k_sc: int = K_SC, overflow_fallback: bool = True,
                    depth: int | None = None, mb: int | None = None,
                    mm: bool = False, t_cap: bool = False,
                    debug_steps: bool = False):
    """Any-hit visibility batch through the bundle walk: (blocked bool
    [N], number of bundles that overflowed k_cand and took the fallback).
    The culls, keys, knobs (but lean) and fallback are
    closest_hit_bundle's: the overflowed bundles' rays re-trace through
    the same kernel at k_cand = C (with depth and mb, not mm or t_cap), or
    the whole batch does past FALLBACK_BUNDLES; debug_steps returns
    (blocked, {"steps", "cand_count", "overflowed"}) and takes no
    fallback."""
    n_orig = origins.shape[0]
    p = bundle_size
    group, m_super = _walk_shape(tables, cull, group, m_super)
    if cull == "sc":
        mm = False
    with span("trace.prep"):
        tn_o = _per_ray(t_min, n_orig, origins)
        tx_o = _per_ray(t_max, n_orig, origins)
        prep = _prepare(clusters, origins, directions, tn_o, tx_o, scene_min,
                        scene_max, p, presorted, cull, k_cand, sort_key,
                        m_super, k_sc, t_cap=t_cap)
        rays8 = _rays8(prep)
    knobs = dict(debug_steps=debug_steps, depth=depth, mb=mb)
    with span("trace.walk"):
        if prep.sc_m:
            rows = walk_occluded_sc(rays8, prep.cand_idx, prep.cand_t,
                                    prep.cand_count, tables.wald_rows, group,
                                    lanes=tables.lanes, **knobs)
        else:
            rows = walk_occluded(rays8, prep.cand_idx, prep.cand_t,
                                 prep.cand_count, tables.wald_rows, group,
                                 lanes=tables.lanes, mm=mm, **knobs)
    rows = rows if isinstance(rows, tuple) else (rows,)
    with span("trace.decode"):
        blocked = _unsort(rows[0][:n_orig], prep.perm) != 0
    if debug_steps:
        return blocked, _debug_info(rows[-1], prep)

    n_ovf = readback.item(prep.overflowed.sum(), "overflow_count")
    if not overflow_fallback or n_ovf == 0:
        return blocked, n_ovf
    with span("trace.fallback"):
        full_k = clusters.num_clusters
        knobs = dict(depth=depth, mb=mb)
        if n_ovf > FALLBACK_BUNDLES:
            blocked, _ = occluded_bundle(
                clusters, tables, origins, directions, tn_o, tx_o, scene_min,
                scene_max, bundle_size=p, presorted=presorted,
                cull=_full_cull(cull), group=group, k_cand=full_k,
                sort_key=sort_key, overflow_fallback=False, **knobs)
            return blocked, n_ovf
        oi = _overflowed_rays(prep, p, n_orig)
        sub, _ = occluded_bundle(
            clusters, tables, origins[oi], directions[oi], tn_o[oi],
            tx_o[oi], scene_min, scene_max, bundle_size=p, presorted=True,
            cull="exact", group=group, k_cand=full_k,
            overflow_fallback=False, **knobs)
        blocked = blocked.index_put((oi,), sub)
    return blocked, n_ovf


# ---------------------------------------------------------------------------
# Candidate-union probe
# ---------------------------------------------------------------------------

def union_max_bundle(clusters: Clusters, origins, directions, t_min, t_max,
                     scene_min, scene_max, bundle_size: int = 128,
                     cull: str = "exact", presorted: bool = False
                     ) -> torch.Tensor:
    """The largest per-bundle candidate union of this batch, the k_cand a
    traversal of these rays needs to truncate nothing (the JAX package's
    union_max_bundle), as a 0-d int32 tensor on the rays' device. The
    bundles are composed as the trace's prep composes them: cand0-sorted
    (unless presorted) exact-cull unions (B3 inside the sort key, B4 for
    the unions on a CUDA batch), or interval-cull unions (sorted by the
    coherence key unless presorted)."""
    n = origins.shape[0]
    p = bundle_size
    tn = _per_ray(t_min, n, origins)
    tx = _per_ray(t_max, n, origins)
    if cull == "interval":
        o, d = origins, directions
        if not presorted:
            perm = tb.sort_rays_for_coherence(origins, directions,
                                              scene_min, scene_max)
            o, d, tn, tx = o[perm], d[perm], tn[perm], tx[perm]
        o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
        o_min, o_max, inv_lo, inv_hi, bundle_tmax = _bundle_bounds(o, d, tx,
                                                                   p)
        c = clusters.num_clusters
        cb = max(1, cull_mod.chunk_bytes(o.device)
                 // (4 * 3 * 12 * max(c, 1)))
        counts = [bundle_cluster_overlap(
            o_min[b0:b0 + cb], o_max[b0:b0 + cb], inv_lo[b0:b0 + cb],
            inv_hi[b0:b0 + cb], bundle_tmax[b0:b0 + cb], clusters.aabb_min,
            clusters.aabb_max)[0].sum(dim=-1)
            for b0 in range(0, o_min.shape[0], cb)]
        return torch.cat(counts).max().to(torch.int32)
    if cull != "exact":
        raise ValueError(f"cull must be 'exact' or 'interval', not {cull!r}")
    if presorted:
        o, d = origins, directions
    else:
        _, o, d, tn, tx = _sorted(clusters, origins, directions, tn, tx,
                                  scene_min, scene_max, "cand0")
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    union = cull_mod.bundle_union(_pack8(o, d, tn, tx), clusters.aabb_min,
                                  clusters.aabb_max, p)
    return torch.isfinite(union).sum(dim=-1).max().to(torch.int32)
