"""Closest-hit and any-hit traversal through the hand-written CUDA walks.

Port of the host side of raytracer2_tpu/ops/pallas_traverse.py
(closest_hit_bundle_pallas, occluded_bundle_pallas) for the ray classes
the frame traces, plus the wrappers of the kernels that replace its Pallas
walks (csrc/bundle_walk.cu, csrc/bundle_occlude.cu) and those kernels'
plain torch versions.

- Pixel tiles (presorted=True, cull="interval"): rays arrive in screen
  Z-order; each bundle's candidates come from the conservative interval
  slab test over all cluster boxes (bundle_cluster_overlap). No sort.
- Bounces (presorted=False, cull="exact"): every ray is slab-tested
  exactly against every cluster box (a chunked dense [rays, C] pass), rays
  are sorted by the cand0 key (nearest overlapped cluster | t_max bucket |
  octant | origin Morton), and each bundle's candidate list is the union
  of its rays' overlaps, ranked nearest first.
- Visibility rays (any hit, presorted in pixel Z-order, cull="exact"):
  the exact cull without the sort; each ray stops at its first hit.

Ranking uses a stable argsort and keeps the first k: jax.lax.top_k breaks
ties by lower index and jnp.argsort is stable, so the candidate order
matches the JAX package's exactly (torch.topk promises no tie order).
uint32 keys are built in int64 with explicit masks.

A bundle whose union exceeds k_cand overflows. Those bundles re-trace
through the same kernel with full-length lists (k_cand = C, exact by
construction); past FALLBACK_BUNDLES of them the whole batch re-traces
at k_cand = C. The TPU tuning knobs (mb, depth, lean, mm, t_cap,
debug_steps, the hier/sc/exact_iv culls and the other sort keys) are not
ported: each gives the same hits as this path.

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
from raytracer2_tpu_torch.ops.traverse_bundle import (
    _bundle_bounds, _expand_bits, _pad_rays)

LANE_PAD = 128  # triangles per cluster row, padded to the lane width
SLOT_BITS = 10  # group * S_pad <= 1024; low key bits carry the winning slot
SLOT_MASK = (1 << SLOT_BITS) - 1
MISS_CODE = 0x7FFFFFFF
NO_HIT_KEY = 0x7FFFFFFF  # above every hit key and every initial key

# elements of one [bundles, P, group*S_pad] temporary of the plain walk
REFERENCE_CHUNK_ELEMS = {"cuda": 1 << 25, "cpu": 1 << 22}
FALLBACK_BUNDLES = 32  # past this many overflowed bundles, re-trace the batch
MAX_BUNDLE = 256  # rays per bundle a kernel takes (csrc/walk_common.cuh)


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


def wald_sc_rows(clusters: Clusters, m: int) -> torch.Tensor:
    """[C2, 16, m*S_pad] with C2 = ceil(C / m): supercluster s's m clusters
    side by side in the lane dimension, cluster g at lanes g*S_pad + lane.
    The clusters that pad C up to C2*m are zero rows (never hit)."""
    rows = wald_rows(clusters)  # [C, 16, S_pad]
    c, r, sp = rows.shape
    n_sc = (c + m - 1) // m
    rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, n_sc * m - c))
    return (rows.reshape(n_sc, m, r, sp).permute(0, 2, 1, 3)
            .reshape(n_sc, r, m * sp).contiguous())


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


def _launch(entry, name, rays8, cand_idx, cand_t, cand_count, wald_rows,
            lanes, b, p, k, sp, group):
    """Launch one walk kernel of the library (it reads the table as
    `lanes`) on the current stream and return its [B*P] i32 output; raises
    if the launch is refused."""
    if p > MAX_BUNDLE or p % 32:
        raise ValueError(f"bundle size {p} must be a multiple of 32, "
                         f"<= {MAX_BUNDLE}")
    _check_lanes(lanes, wald_rows)
    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    order = torch.empty(b, dtype=torch.int32, device=rays8.device)
    out = torch.empty(b * p, dtype=torch.int32, device=rays8.device)
    with torch.cuda.device(rays8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            rays8.data_ptr(), cand_idx.data_ptr(), cand_t.data_ptr(),
            cand_count.data_ptr(), lanes.coeffs.data_ptr(),
            lanes.count.data_ptr(), order.data_ptr(), out.data_ptr(), b, p,
            k, sp, group, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    return out


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


def _wald_test(r, wr):
    """The Wald unit-triangle test of rays r [nb, P, 8] against rows wr
    [nb, 12, 1, W]: (t, hit) [nb, P, W] with hit = |d'_z| > 1e-12, u >= 0,
    v >= 0, u + v <= 1, t > t_min. The affines are unfused, in the order of
    the kernels' csrc/walk_common.cuh, so the two agree bit for bit."""
    ox, oy, oz, dx, dy, dz, tn = (r[..., i:i + 1] for i in range(7))
    op_u = ox * wr[:, 0] + oy * wr[:, 3] + oz * wr[:, 6] + wr[:, 9]
    op_v = ox * wr[:, 1] + oy * wr[:, 4] + oz * wr[:, 7] + wr[:, 10]
    op_z = ox * wr[:, 2] + oy * wr[:, 5] + oz * wr[:, 8] + wr[:, 11]
    dp_u = dx * wr[:, 0] + dy * wr[:, 3] + dz * wr[:, 6]
    dp_v = dx * wr[:, 1] + dy * wr[:, 4] + dz * wr[:, 7]
    dp_z = dx * wr[:, 2] + dy * wr[:, 5] + dz * wr[:, 8]
    t = -op_z / dp_z
    uu = op_u + t * dp_u
    vv = op_v + t * dp_v
    hit = ((torch.abs(dp_z) > 1e-12) & (uu >= 0.0) & (vv >= 0.0)
           & (uu + vv <= 1.0) & (t > tn))
    return t, hit


def _real_lanes(lane_real, ci, live):
    """[nb, W] bool: the step's lanes that hold a real triangle of a live
    candidate. lane_real [C, S_pad] marks each cluster's real triangles."""
    return lane_real[ci.long()].reshape(live.shape) & live


def walk_closest(rays8, cand_idx, cand_t, cand_count, wald_rows, group, *,
                 lanes: WalkLanes):
    """Closest-hit bundle walk: winner code [B*P] i32 per ray (cluster *
    S_pad + slot, 0x7FFFFFFF on a miss). rays8 [B*P, 8] f32 rows (ox oy oz
    dx dy dz t_min t_max) in bundle order; cand_idx/cand_t [B, K] nearest
    first, cand_count [B]; wald_rows [C, 16, S_pad] and lanes, its
    walk_lanes (WalkTables.lanes).

    A CUDA tensor launches csrc/bundle_walk.cu on the current stream (and
    counts the launch in walk_closest.launches); the kernel reads the
    table as `lanes`. A CPU tensor runs walk_closest_reference on
    wald_rows. Anything else raises."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    if rays8.device.type == "cpu":
        return walk_closest_reference(rays8, cand_idx, cand_t, cand_count,
                                      wald_rows, group)
    if rays8.device.type != "cuda":
        raise ValueError(f"walk_closest runs on cuda or cpu, "
                         f"not {rays8.device}")
    out = _launch("rt2_walk_closest", "walk_closest", rays8, cand_idx,
                  cand_t, cand_count, wald_rows, lanes, b, p, k, sp, group)
    walk_closest.launches += 1
    return out


walk_closest.launches = 0


def walk_closest_reference(rays8, cand_idx, cand_t, cand_count, wald_rows,
                           group, lane_real=None):
    """Plain torch version of the walk, batched over bundles: the same
    steps, predicates, packed keys, tie rule and early exit as the kernel,
    with the Wald affines in the same unfused order, so the two agree bit
    for bit. Given lane_real ([C, S_pad] bool, True on a real triangle's
    lane), it also returns the WalkWork these inputs need."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    dev = rays8.device
    w = group * sp
    bc = _chunk_bundles(dev, p, w)
    lane = torch.arange(w, device=dev)
    grp = lane // sp
    lane_in = lane % sp
    out = torch.empty((b, p), dtype=torch.int32, device=dev)
    work = _new_work(b, dev)
    rays = rays8.reshape(b, p, 8)
    for b0 in range(0, b, bc):
        r = rays[b0:b0 + bc]
        nb = r.shape[0]
        best_key = (r[..., 7].view(torch.int32) & ~SLOT_MASK) | SLOT_MASK
        best_code = torch.full((nb, p), MISS_CODE, dtype=torch.int32,
                               device=dev)
        n = cand_count[b0:b0 + bc]
        alive = torch.ones(nb, dtype=torch.bool, device=dev)
        for k0 in range(0, int(n.max()), group):
            worst = (best_key | SLOT_MASK).view(torch.float32).amax(dim=1)
            alive &= (k0 < n) & (cand_t[b0:b0 + bc, k0] <= worst)
            if not bool(alive.any()):
                break
            ci, wr = _step_rows(cand_idx[b0:b0 + bc], wald_rows, k0, group)
            t, hit = _wald_test(r, wr)
            live = (lane[None, :] < (n[:, None] - k0) * sp) & alive[:, None]
            if lane_real is not None:
                work.steps[b0:b0 + nb] += alive
                work.ray_lanes.add_(
                    p * _real_lanes(lane_real, ci, live).sum())
            hit &= live[:, None, :]
            key = torch.where(
                hit, (t.view(torch.int32) & ~SLOT_MASK) | lane.to(torch.int32),
                NO_HIT_KEY)
            step_key, arg = key.min(dim=-1)  # [nb, P]
            step_code = (torch.gather(ci, 1, grp[arg].reshape(nb, -1))
                         .reshape(nb, p) * sp + lane_in[arg])
            better = step_key < best_key
            best_key = torch.where(better, step_key, best_key)
            best_code = torch.where(better, step_code.to(torch.int32),
                                    best_code)
        out[b0:b0 + nb] = best_code
    out = out.reshape(b * p)
    return out if lane_real is None else (out, work)


def walk_occluded(rays8, cand_idx, cand_t, cand_count, wald_rows, group, *,
                  lanes: WalkLanes):
    """Any-hit bundle walk: [B*P] i32 per ray, 1 where a triangle blocks
    the open segment (t_min, t_max), else 0; rays with t_max <= t_min
    (padding) report 0. Arguments as walk_closest's.

    A CUDA tensor launches csrc/bundle_occlude.cu on the current stream
    (and counts the launch in walk_occluded.launches); the kernel reads the
    table as `lanes`. A CPU tensor runs walk_occluded_reference on
    wald_rows. Anything else raises."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    if rays8.device.type == "cpu":
        return walk_occluded_reference(rays8, cand_idx, cand_t, cand_count,
                                       wald_rows, group)
    if rays8.device.type != "cuda":
        raise ValueError(f"walk_occluded runs on cuda or cpu, "
                         f"not {rays8.device}")
    out = _launch("rt2_walk_occluded", "walk_occluded", rays8, cand_idx,
                  cand_t, cand_count, wald_rows, lanes, b, p, k, sp, group)
    walk_occluded.launches += 1
    return out


walk_occluded.launches = 0


def walk_occluded_reference(rays8, cand_idx, cand_t, cand_count, wald_rows,
                            group, lane_real=None):
    """Plain torch version of the any-hit walk, batched over bundles: the
    same steps, predicates and exits as the kernel (a ray is done at its
    first hit; a bundle stops when every ray is done, its candidates run
    out, or the next entry distance exceeds the largest t_max of its live
    rays, NaN ending the walk), with the kernel's Wald test, so the two
    agree bit for bit. Given lane_real, it also returns the WalkWork, as
    walk_closest_reference does."""
    b, k, p, sp = _check_walk_args(rays8, cand_idx, cand_t, cand_count,
                                   wald_rows, group)
    dev = rays8.device
    w = group * sp
    bc = _chunk_bundles(dev, p, w)
    lane = torch.arange(w, device=dev)
    out = torch.empty((b, p), dtype=torch.int32, device=dev)
    work = _new_work(b, dev)
    rays = rays8.reshape(b, p, 8)
    for b0 in range(0, b, bc):
        r = rays[b0:b0 + bc]
        nb = r.shape[0]
        done = (r[..., 7] <= r[..., 6])
        n = cand_count[b0:b0 + bc]
        alive = torch.ones(nb, dtype=torch.bool, device=dev)
        for k0 in range(0, int(n.max()), group):
            worst = torch.where(done, -torch.inf, r[..., 7]).amax(dim=1)
            alive &= (k0 < n) & (cand_t[b0:b0 + bc, k0] <= worst)
            if not bool(alive.any()):
                break
            ci, wr = _step_rows(cand_idx[b0:b0 + bc], wald_rows, k0, group)
            t, hit = _wald_test(r, wr)
            live = (lane[None, :] < (n[:, None] - k0) * sp) & alive[:, None]
            hit &= (t < r[..., 7:8]) & live[:, None, :]
            step_hit = hit.any(dim=-1)
            if lane_real is not None:
                # real triangles a testing ray tests: up to and including
                # its first hit, else all of the step's
                upto = _real_lanes(lane_real, ci, live).cumsum(dim=-1)
                first = hit.to(torch.uint8).argmax(dim=-1)  # [nb, P]
                tested = torch.where(step_hit, torch.gather(upto, 1, first),
                                     upto[:, -1:])
                work.steps[b0:b0 + nb] += alive
                work.ray_lanes.add_((tested * ~done).sum())
            done |= step_hit
        out[b0:b0 + nb] = (done & (r[..., 7] > r[..., 6])).to(torch.int32)
    out = out.reshape(b * p)
    return out if lane_real is None else (out, work)


# ---------------------------------------------------------------------------
# Candidate prep
# ---------------------------------------------------------------------------

def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def cand0_sort_key(rays8, amin, amax, scene_min, scene_max):
    """Per-ray sort key of [N, 8] ray rows (int64 holding uint32): [nearest
    exactly-overlapped box id | t_max bucket | octant | origin Morton]. Rays
    that touch nothing key to C and compact into empty bundles."""
    c = amin.shape[0]
    cand0 = cull_mod.nearest_box(rays8, amin, amax).long()
    o, d, tx = rays8[:, 0:3], rays8[:, 3:6], rays8[:, 7]

    # tiebreak (t_max bucket | octant | origin morton): short rays bundle
    # together; then direction octant + origin morton for coherence
    octant = ((d[:, 0] >= 0).long() | ((d[:, 1] >= 0).long() << 1)
              | ((d[:, 2] >= 0).long() << 2))
    span = scene_max - scene_min
    extent = torch.clamp_min(span, 1e-12)
    diag = _norm3(span)
    q = torch.clamp((o - scene_min) / extent, 0.0, 0.999)
    ocell = (q * 32.0).long()
    o_morton = (_expand_bits(ocell[:, 0], 5)
                | (_expand_bits(ocell[:, 1], 5) << 1)
                | (_expand_bits(ocell[:, 2], 5) << 2))
    # dead lanes carry tx = -1: clamp BEFORE the integer conversion (the
    # JAX uint32 cast of a negative float saturates to 0)
    t_bucket = torch.clamp(4.0 * tx / torch.clamp_min(diag, 1e-12),
                           0.0, 3.0).long()
    tie = (t_bucket << 18) | (octant << 15) | o_morton  # 20 bits

    bits_c = max((c + 1).bit_length(), 1)
    tie_bits = max(32 - bits_c, 0)
    if tie_bits >= 20:
        tie_part = tie << (tie_bits - 20)
    else:
        tie_part = tie >> (20 - tie_bits)
    return ((cand0 << tie_bits) | tie_part) & 0xFFFFFFFF


class Prep(NamedTuple):
    """Bundled rays and their candidate lists. Rays are in bundle order
    (perm maps bundle row -> caller row; None when presorted) and padded
    to whole bundles; candidate arrays are [B, k] nearest first."""

    perm: torch.Tensor | None
    o: torch.Tensor
    d: torch.Tensor
    tn: torch.Tensor
    tx: torch.Tensor
    cand_idx: torch.Tensor  # [B, k] i32
    cand_t: torch.Tensor  # [B, k] f32 entry distances (+inf past the union)
    cand_count: torch.Tensor  # [B] i32
    overflowed: torch.Tensor  # [B] bool: union larger than k


def _rank(entry: torch.Tensor, k: int):
    """Nearest-first candidates of [B, C] entry distances: stable argsort
    and the first k (ties to the lower index, as jax.lax.top_k)."""
    idx = torch.argsort(entry, dim=-1, stable=True)[:, :k]
    cand_t = torch.gather(entry, 1, idx)
    n_union = torch.isfinite(entry).sum(dim=-1)
    cand_count = torch.minimum(torch.isfinite(cand_t).sum(dim=-1), n_union)
    return idx.to(torch.int32), cand_t, cand_count.to(torch.int32), n_union > k


def _finish(perm, o, d, tn, tx, parts) -> Prep:
    idx, ct, cnt, ovf = (torch.cat(x) for x in zip(*parts))
    return Prep(perm, o, d, tn, tx, idx.contiguous(), ct.contiguous(),
                cnt.contiguous(), ovf)


def _cand0_sort(clusters: Clusters, origins, directions, t_min, t_max,
                scene_min, scene_max):
    """The rays in cand0-key order (a stable argsort, as jnp.argsort):
    (perm, o, d, tn, tx), perm mapping sorted row -> caller row."""
    rays8 = _pack8(origins, directions, t_min, t_max)
    key = cand0_sort_key(rays8, clusters.aabb_min, clusters.aabb_max,
                         scene_min, scene_max)
    perm = torch.argsort(key, stable=True)
    packed = rays8[perm]
    return perm, packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7]


def prepare_bundles_exact(clusters: Clusters, origins, directions, t_min,
                          t_max, scene_min, scene_max, bundle_size: int,
                          presorted: bool, k_cand: int) -> Prep:
    """Exact-cull prep (JAX _prepare_bundles_exact with sort_key="cand0"):
    per-ray slab tests, cand0 ray sort (unless presorted), per-bundle union
    candidate lists ranked nearest first."""
    p = bundle_size
    c = clusters.num_clusters
    if presorted:
        perm = None
        o, d, tn, tx = origins, directions, t_min, t_max
    else:
        perm, o, d, tn, tx = _cand0_sort(clusters, origins, directions,
                                         t_min, t_max, scene_min, scene_max)
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    k = min(k_cand, c)
    union = cull_mod.bundle_union(_pack8(o, d, tn, tx), clusters.aabb_min,
                                  clusters.aabb_max, p)
    # rank in chunks of bundles: the stable argsort's [bundles, C] i64
    # temporaries stay under the cull's chunk bound
    cb = max(1, cull_mod.chunk_bytes(o.device) // (8 * c))
    parts = [_rank(union[b0:b0 + cb], k)
             for b0 in range(0, union.shape[0], cb)]
    return _finish(perm, o, d, tn, tx, parts)


def prepare_bundles_interval(clusters: Clusters, origins, directions, t_min,
                             t_max, bundle_size: int, k_cand: int) -> Prep:
    """Interval-union prep for presorted rays (JAX _prepare_bundles with
    presorted=True): per-bundle candidates from the conservative interval
    slab test over all clusters, ranked nearest first."""
    p = bundle_size
    c = clusters.num_clusters
    o, d, tn, tx, _ = _pad_rays(origins, directions, t_min, t_max, p)
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
    return _finish(None, o, d, tn, tx, parts)


# ---------------------------------------------------------------------------
# Closest hit
# ---------------------------------------------------------------------------

def _per_ray(x, n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=ref.device).expand(n).contiguous()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the float64 product of two float32
    values is exact, so only the sum rounds (twice, to float64 and then to
    float32, which differs from one rounding on a vanishing share of
    inputs)."""
    return (a.double() * b.double() + c.double()).float()


def _decode(code, meta_rows, on, dn, t_max_orig) -> HitRecord:
    """Winner code -> payload ids via one meta-row gather, then the 12-term
    re-evaluation of the winner's exact (t, u, v) in the caller's order."""
    missed = code == MISS_CODE
    meta = meta_rows[torch.where(missed, 0, code).long()]  # [n, 16] i32
    tri_r = torch.where(missed, -1, meta[:, 12])
    geom_r = torch.where(missed, -1, meta[:, 13])
    prim_r = torch.where(missed, 0, meta[:, 14])

    # XLA contracts these affines into fused multiply-adds, which torch's
    # elementwise ops do not offer; _fma rounds each of them once, as XLA
    # does, in XLA's order, so (t, u, v) equal the JAX package's bit for bit
    wf = meta[:, 0:12].contiguous().view(torch.float32)

    def affine(r, x, bias=None):
        # ((w_r x0 + w_r+3 x1) + w_r+6 x2) [+ bias] as XLA fuses it
        acc = _fma(wf[:, r + 6], x[:, 2],
                   _fma(wf[:, r], x[:, 0], wf[:, r + 3] * x[:, 1]))
        return acc if bias is None else acc + wf[:, bias]

    op_u, op_v, op_z = (affine(r, on, r + 9) for r in range(3))
    dp_u, dp_v, dzv = (affine(r, dn) for r in range(3))
    t_r = -op_z / torch.where(dzv == 0.0, 1.0, dzv)
    u_r = _fma(t_r, dp_u, op_u)
    v_r = _fma(t_r, dp_v, op_v)
    missed_r = tri_r < 0

    return HitRecord(
        t=torch.where(missed_r, t_max_orig, t_r),
        u=torch.where(missed_r, 0.0, u_r),
        v=torch.where(missed_r, 0.0, v_r),
        geometry_index=torch.where(missed_r, INVALID_INDEX, geom_r.long()),
        primitive_id=torch.where(missed_r, 0, prim_r.long()),
        triangle_index=tri_r)


def _prepare(clusters: Clusters, origins, directions, tn_o, tx_o,
             scene_min, scene_max, p: int, presorted: bool, cull: str,
             k_cand: int) -> Prep:
    if cull == "interval":
        if not presorted:
            raise NotImplementedError(
                "the interval cull is ported for presorted rays only")
        return prepare_bundles_interval(clusters, origins, directions, tn_o,
                                        tx_o, p, k_cand)
    if cull == "exact":
        return prepare_bundles_exact(clusters, origins, directions, tn_o,
                                     tx_o, scene_min, scene_max, p,
                                     presorted, k_cand)
    raise ValueError(f"cull must be 'exact' or 'interval', not {cull!r}")


def _pack8(o, d, tn, tx) -> torch.Tensor:
    """[N, 8] f32 ray rows (ox oy oz dx dy dz t_min t_max)."""
    return torch.cat([o, d, tn[:, None], tx[:, None]], dim=1).contiguous()


def _rays8(prep: Prep) -> torch.Tensor:
    return _pack8(prep.o, prep.d, prep.tn, prep.tx)


def _unsort(x: torch.Tensor, prep: Prep) -> torch.Tensor:
    """Bundle order -> caller order with one scatter (identity when the
    rays were presorted)."""
    if prep.perm is None:
        return x
    return torch.empty_like(x).index_put_((prep.perm,), x)


def _overflowed_rays(prep: Prep, p: int, n_orig: int) -> torch.Tensor:
    """Caller rows of the rays of the bundles whose union overflowed, in
    their bundle order."""
    bidx = torch.nonzero(prep.overflowed).reshape(-1)
    j = (bidx[:, None] * p + torch.arange(p, device=bidx.device)).reshape(-1)
    j = j[j < n_orig]
    return prep.perm[j] if prep.perm is not None else j


def closest_hit_bundle(clusters: Clusters, tables: WalkTables,
                       origins: torch.Tensor, directions: torch.Tensor,
                       t_min, t_max, scene_min: torch.Tensor,
                       scene_max: torch.Tensor, *, bundle_size: int = 128,
                       presorted: bool = False, cull: str = "exact",
                       group: int = 4, k_cand: int = 256,
                       overflow_fallback: bool = True
                       ) -> tuple[HitRecord, int]:
    """Closest hit through the bundle walk. Returns (HitRecord, number of
    bundles that overflowed k_cand and took the fallback).

    cull="interval" needs presorted rays (pixel tiles); cull="exact" sorts
    by the cand0 key unless presorted."""
    n_orig = origins.shape[0]
    p = bundle_size
    sp = tables.wald_rows.shape[-1]
    group = max(1, min(group, (1 << SLOT_BITS) // sp))
    tn_o = _per_ray(t_min, n_orig, origins)
    tx_o = _per_ray(t_max, n_orig, origins)
    prep = _prepare(clusters, origins, directions, tn_o, tx_o, scene_min,
                    scene_max, p, presorted, cull, k_cand)
    code = walk_closest(_rays8(prep), prep.cand_idx, prep.cand_t,
                        prep.cand_count, tables.wald_rows, group,
                        lanes=tables.lanes)[:n_orig]
    # un-sort the codes, then decode in caller order
    rec = _decode(_unsort(code, prep), tables.meta_rows, origins,
                  directions, tx_o)

    n_ovf = int(prep.overflowed.sum())
    if not overflow_fallback or n_ovf == 0:
        return rec, n_ovf
    full_k = clusters.num_clusters
    if n_ovf > FALLBACK_BUNDLES:
        rec, _ = closest_hit_bundle(
            clusters, tables, origins, directions, tn_o, tx_o, scene_min,
            scene_max, bundle_size=p, presorted=presorted, cull=cull,
            group=group, k_cand=full_k, overflow_fallback=False)
        return rec, n_ovf
    # re-trace only the overflowed bundles' rays, in their bundle order,
    # with full-length candidate lists (cannot truncate => exact)
    oi = _overflowed_rays(prep, p, n_orig)
    sub, _ = closest_hit_bundle(
        clusters, tables, origins[oi], directions[oi], tn_o[oi], tx_o[oi],
        scene_min, scene_max, bundle_size=p, presorted=True, cull="exact",
        group=group, k_cand=full_k, overflow_fallback=False)
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
                    presorted: bool = False, group: int = 4,
                    k_cand: int = 256, overflow_fallback: bool = True
                    ) -> tuple[torch.Tensor, int]:
    """Any-hit visibility batch through the bundle walk (the exact cull;
    cand0-sorted unless presorted): (blocked bool [N], number of bundles
    that overflowed k_cand and took the fallback). The fallback is the
    closest-hit one: the overflowed bundles' rays re-trace through the same
    kernel at k_cand = C, or the whole batch does past FALLBACK_BUNDLES."""
    n_orig = origins.shape[0]
    p = bundle_size
    sp = tables.wald_rows.shape[-1]
    group = max(1, min(group, (1 << SLOT_BITS) // sp))
    tn_o = _per_ray(t_min, n_orig, origins)
    tx_o = _per_ray(t_max, n_orig, origins)
    prep = _prepare(clusters, origins, directions, tn_o, tx_o, scene_min,
                    scene_max, p, presorted, "exact", k_cand)
    hit = walk_occluded(_rays8(prep), prep.cand_idx, prep.cand_t,
                        prep.cand_count, tables.wald_rows, group,
                        lanes=tables.lanes)[:n_orig]
    blocked = _unsort(hit, prep) != 0

    n_ovf = int(prep.overflowed.sum())
    if not overflow_fallback or n_ovf == 0:
        return blocked, n_ovf
    full_k = clusters.num_clusters
    if n_ovf > FALLBACK_BUNDLES:
        blocked, _ = occluded_bundle(
            clusters, tables, origins, directions, tn_o, tx_o, scene_min,
            scene_max, bundle_size=p, presorted=presorted, group=group,
            k_cand=full_k, overflow_fallback=False)
        return blocked, n_ovf
    oi = _overflowed_rays(prep, p, n_orig)
    sub, _ = occluded_bundle(
        clusters, tables, origins[oi], directions[oi], tn_o[oi], tx_o[oi],
        scene_min, scene_max, bundle_size=p, presorted=True, group=group,
        k_cand=full_k, overflow_fallback=False)
    return blocked.index_put((oi,), sub), n_ovf


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
    the unions on a CUDA batch), or interval-cull unions of presorted
    pixel tiles."""
    n = origins.shape[0]
    p = bundle_size
    tn = _per_ray(t_min, n, origins)
    tx = _per_ray(t_max, n, origins)
    if cull == "interval":
        if not presorted:
            raise NotImplementedError(
                "the interval cull is ported for presorted rays only")
        o, d, tn, tx, _ = _pad_rays(origins, directions, tn, tx, p)
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
        _, o, d, tn, tx = _cand0_sort(clusters, origins, directions, tn, tx,
                                      scene_min, scene_max)
    o, d, tn, tx, _ = _pad_rays(o, d, tn, tx, p)
    union = cull_mod.bundle_union(_pack8(o, d, tn, tx), clusters.aabb_min,
                                  clusters.aabb_max, p)
    return torch.isfinite(union).sum(dim=-1).max().to(torch.int32)
