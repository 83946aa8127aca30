"""Pair-sweep traversal engine, port of raytracer2_tpu/ops/pallas_pairs.py.

Per batch of rays:

1. bin_pairs: every ray is slab-tested against every supercluster box
   (`group` clusters each; a dense [rays, C2] torch pass), keeps its k_cand
   nearest overlapped superclusters (a stable argsort, ties to the lower
   index as jax.lax.top_k), and the (ray, supercluster) pairs are binned by
   supercluster into blocks of PAIR_P rays, each supercluster's run padded
   to whole blocks. The binning is the stable counting sort of
   ops/binning.py (B6, csrc/binning.cu), which gives the JAX package's
   stable jnp.argsort layout slot for slot.
2. pair_sweep (B5, csrc/pair_sweep.cu): each block tests its rays against
   every lane of its supercluster's Wald rows and keeps per ray the packed
   key (bits(t) & ~slot_mask) | lane, MISS_KEY where nothing hits. The
   kernel reads the rows lane-major, member cluster by member cluster, from
   the walk tables (WalkTables.lanes: member m of supercluster s is cluster
   s * group + m) and tests each cluster's real lanes only.
3. A scatter-min per ray picks the best key, then the winning pair's code
   supercluster * W + lane, which is cluster * S_pad + lane, decodes
   through the bundle engine's meta rows (cuda_traverse.hit_decode).

A ray that overlaps more than k_cand superclusters would lose candidates:
then the whole input re-traces through the bundle engine
(cuda_traverse.closest_hit_bundle / occluded_bundle) at the shapes the
JAX fallback uses, so hits are exact either way.

On a CUDA tensor pair_sweep launches its kernel (counted in
pair_sweep.launches); on a CPU tensor it runs pair_sweep_reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer2_tpu_torch.ops import binning
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import Clusters
from raytracer2_tpu_torch.ops.intersect import HitRecord
from raytracer2_tpu_torch.ops.wald import hit_test

PAIR_P = 128  # rays per pair block
MISS_KEY = 0x7F000000  # bits of ~1.7e38: above any real hit key
MAX_LANES = 2048  # group * S_pad: the key carries the lane in 11 bits
PAIR_RAY_BATCH = 262144  # rays per bin-and-sweep batch (JAX's ray_batch)
DEAD_PAIR_ROW = (0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0)
# the bundle engine's shapes when a trace overflows k_cand: the JAX
# fallback's defaults (closest_hit_bundle_pallas, occluded_bundle_pallas)
FALLBACK_CLOSEST = dict(bundle_size=128, presorted=False, cull="exact",
                        group=4, k_cand=256)
FALLBACK_OCCLUDED = dict(bundle_size=64, presorted=False, group=4,
                         k_cand=256)


class PairScene(NamedTuple):
    """Per-scene tables of the pair engine (built once by make_tracers)."""

    sc_min: torch.Tensor  # [C2, 3] supercluster box minima
    sc_max: torch.Tensor  # [C2, 3]
    wald_sc: torch.Tensor  # [C2, 16, W] f32, W = group * S_pad
    meta_rows: torch.Tensor  # [C * S_pad, 16] i32 winner-code decode table
    group: int  # clusters per supercluster
    s_pad: int

    @property
    def num_superclusters(self) -> int:
        return self.sc_min.shape[0]

    @property
    def lanes(self) -> int:  # W
        return self.wald_sc.shape[-1]


def build_pair_scene(clusters: Clusters, tri_geometry: torch.Tensor,
                     tri_primitive: torch.Tensor, group: int = 16
                     ) -> PairScene:
    """Group clusters into superclusters of `group`; the clusters that pad
    C to a whole number of groups get inverted +-1e30 boxes (they widen no
    supercluster box) and zero Wald rows."""
    c = clusters.num_clusters
    sp = ct.s_pad(clusters)
    if group * sp > MAX_LANES:
        raise ValueError("pair keys carry the lane slot in 11 bits: "
                         f"group {group} x S_pad {sp} > {MAX_LANES}")
    pad = (-c) % group
    amin, amax = clusters.aabb_min, clusters.aabb_max
    if pad:
        amin = torch.cat([amin, amin.new_full((pad, 3), 1e30)])
        amax = torch.cat([amax, amax.new_full((pad, 3), -1e30)])
    c2 = (c + pad) // group
    return PairScene(
        sc_min=amin.reshape(c2, group, 3).amin(dim=1).contiguous(),
        sc_max=amax.reshape(c2, group, 3).amax(dim=1).contiguous(),
        wald_sc=ct.wald_sc_rows(clusters, group),
        meta_rows=ct.tri_meta(clusters, tri_geometry, tri_primitive),
        group=group, s_pad=sp)


def _slot_mask(w: int) -> int:
    bits = max((w - 1).bit_length(), 1)
    return (1 << bits) - 1


# ---------------------------------------------------------------------------
# B5: the pair sweep and its plain version
# ---------------------------------------------------------------------------

def _check_sweep_args(rays8, block_sc, block_live, wald_sc):
    if block_sc.dim() != 1:
        raise ValueError(f"block_sc must be [n_blocks], got "
                         f"{tuple(block_sc.shape)}")
    nblk = block_sc.shape[0]
    for name, x, dtype in (("rays8_pairs", rays8, torch.float32),
                           ("block_sc", block_sc, torch.int32),
                           ("block_live", block_live, torch.int32),
                           ("wald_sc", wald_sc, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != rays8.device:
            raise ValueError(f"{name} is on {x.device}, rays8_pairs on "
                             f"{rays8.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(rays8.shape) != (nblk * PAIR_P, 8) or \
            tuple(block_live.shape) != (nblk,):
        raise ValueError(f"rays8_pairs {tuple(rays8.shape)} and block_live "
                         f"{tuple(block_live.shape)} must be "
                         f"[{nblk * PAIR_P}, 8] and [{nblk}]")
    if wald_sc.dim() != 3 or wald_sc.shape[1] != 16 or wald_sc.shape[0] == 0 \
            or not 0 < wald_sc.shape[2] <= MAX_LANES:
        raise ValueError(f"wald_sc must be [C2, 16, W <= {MAX_LANES}], got "
                         f"{tuple(wald_sc.shape)}")
    if rays8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_sweep runs on cuda or cpu, not "
                         f"{rays8.device}")
    return nblk, wald_sc.shape[0], wald_sc.shape[2]


def _check_lanes(lanes: ct.WalkLanes, wald_sc: torch.Tensor
                 ) -> tuple[int, int]:
    """(clusters C, members per supercluster) of the walk tables' lanes
    that wald_sc interleaves; raises if the table does not fit it: [C,
    S_pad, 12] f32 and [C] i32 with W = group * S_pad and C2 = ceil(C /
    group)."""
    c2, _, w = wald_sc.shape
    c = lanes.count.shape[0] if lanes.count.dim() == 1 else 0
    sp = lanes.coeffs.shape[1] if lanes.coeffs.dim() == 3 else 0
    group = w // sp if sp and w % sp == 0 else 0
    fits = bool(group) and (c2 - 1) * group < c <= c2 * group
    for name, x, dtype, shape in (
            ("lanes.coeffs", lanes.coeffs, torch.float32, (c, sp, 12)),
            ("lanes.count", lanes.count, torch.int32, (c,))):
        if not fits or x.dtype != dtype or tuple(x.shape) != shape \
                or x.device != wald_sc.device or not x.is_contiguous():
            raise ValueError(f"{name} must be the contiguous {dtype} walk "
                             f"table (WalkTables.lanes) of the clusters "
                             f"that wald_sc {tuple(wald_sc.shape)} on "
                             f"{wald_sc.device} interleaves, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return c, group


def pair_sweep(rays8_pairs: torch.Tensor, block_sc: torch.Tensor,
               block_live: torch.Tensor, wald_sc: torch.Tensor, *,
               lanes: ct.WalkLanes) -> torch.Tensor:
    """[n_blocks * PAIR_P] i32 packed winner keys: per pair ray the min over
    its block's supercluster lanes of (bits(t) & ~slot_mask) | lane where
    the lane hits (t_min < t < t_max), MISS_KEY where none does or the
    block is dead (block_live == 0, or block_sc outside [0, C2)).
    rays8_pairs [n_blocks * PAIR_P, 8] f32 in pair order, block_sc and
    block_live [n_blocks] i32, wald_sc [C2, 16, W] f32 and lanes, the
    walk tables' lane-major view of the same clusters (WalkTables.lanes).

    A CUDA tensor launches csrc/pair_sweep.cu on the current stream (it
    reads `lanes`); a CPU tensor runs pair_sweep_reference (it reads
    wald_sc)."""
    nblk, c2, w = _check_sweep_args(rays8_pairs, block_sc, block_live,
                                    wald_sc)
    c, group = _check_lanes(lanes, wald_sc)
    if rays8_pairs.device.type == "cpu":
        return pair_sweep_reference(rays8_pairs, block_sc, block_live,
                                    wald_sc)
    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    keys = torch.empty(nblk * PAIR_P, dtype=torch.int32,
                       device=rays8_pairs.device)
    with torch.cuda.device(rays8_pairs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt2_pair_sweep(
            rays8_pairs.data_ptr(), block_sc.data_ptr(),
            block_live.data_ptr(), lanes.coeffs.data_ptr(),
            lanes.count.data_ptr(), keys.data_ptr(), nblk, c2, c, group,
            w // group, _slot_mask(w), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"pair_sweep launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    pair_sweep.launches += 1
    return keys


pair_sweep.launches = 0


def pair_sweep_reference(rays8_pairs: torch.Tensor, block_sc: torch.Tensor,
                         block_live: torch.Tensor, wald_sc: torch.Tensor
                         ) -> torch.Tensor:
    """Plain torch version of pair_sweep over the live blocks, in chunks:
    wald.hit_test (XLA's contracted affines, which the kernels
    write with __fmaf_rn) plus the open t < t_max end, so the two agree
    bit for bit."""
    nblk, c2, w = _check_sweep_args(rays8_pairs, block_sc, block_live,
                                    wald_sc)
    dev = rays8_pairs.device
    bc = max(1, ct.REFERENCE_CHUNK_ELEMS[dev.type] // (PAIR_P * w))
    lane = torch.arange(w, dtype=torch.int32, device=dev)
    slot_mask = _slot_mask(w)
    out = torch.full((nblk, PAIR_P), MISS_KEY, dtype=torch.int32, device=dev)
    rays = rays8_pairs.reshape(nblk, PAIR_P, 8)
    live = torch.nonzero((block_live != 0) & (block_sc >= 0)
                         & (block_sc < c2)).reshape(-1)
    for s in range(0, live.numel(), bc):
        b = live[s:s + bc]
        r = rays[b]
        wr = wald_sc[block_sc[b].long(), :12, None, :]  # [nb, 12, 1, W]
        t, hit = hit_test(r, wr)
        hit &= t < r[..., 7:8]
        key = torch.where(hit, (t.view(torch.int32) & ~slot_mask) | lane,
                          MISS_KEY)
        out[b] = key.amin(dim=-1)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _slab_entry(ps: PairScene, o, d, tn, tx):
    """_bin_pairs's exact slab test of each ray against each supercluster
    box: ([n, C2] entry distance, +inf where the [t_min, t_max] segment
    misses the box or t_max < 0; [n] count of the boxes overlapped).
    torch.minimum/maximum propagate NaN as jnp.min/max do."""
    eps = 1e-12
    ds = torch.where(torch.abs(d) < eps, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / ds
    near = far = None
    for ax in range(3):
        t0 = (ps.sc_min[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (ps.sc_max[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    mask = ((near <= far) & (far >= tn[:, None]) & (near <= tx[:, None])
            & (tx >= 0.0)[:, None])
    # max(near, 0) with +0 for a near of -0, as XLA's max gives it
    entry = torch.where(mask, torch.where(near > 0.0, near, 0.0), torch.inf)
    return entry, mask.sum(dim=-1)


def pool_size(n: int, k: int, c2: int) -> int:
    """Pair slots of a batch of n rays: every ray's k candidates plus one
    padding block per supercluster, in whole blocks (JAX's static pool)."""
    return ((n * k + c2 * PAIR_P) // PAIR_P) * PAIR_P


def bin_pairs(ps: PairScene, origins, directions, t_min, t_max,
              k_cand: int):
    """Exact cull and binning (port of _bin_pairs): (pair_ray [tp] i32 ray
    index per pair slot, -1 where empty; block_sc [tp / PAIR_P] i32;
    block_live [tp / PAIR_P] i32; overflow, a 0-d bool tensor: some ray
    overlaps more than k superclusters)."""
    n = origins.shape[0]
    c2 = ps.num_superclusters
    p = PAIR_P
    k = min(k_cand, c2)
    entry, n_overlap = _slab_entry(ps, origins, directions, t_min, t_max)
    overflow = (n_overlap > k).any()

    cand = torch.argsort(entry, dim=-1, stable=True)[:, :k]  # nearest first
    cand_live = torch.isfinite(torch.gather(entry, 1, cand))
    del entry
    flat_sc = torch.where(cand_live, cand, c2).to(torch.int32).reshape(-1)
    tp = pool_size(n, k, c2)
    binned = binning.bin_scatter(flat_sc, c2 + 1, pad=p, n_write=c2, div=k,
                                 out_size=tp)

    count_sc = binned.counts[:c2].long()
    padded = (count_sc + p - 1) // p * p
    padded_cum = torch.cumsum(padded, 0)
    padded_base = padded_cum - padded
    first = torch.arange(0, tp, p, device=origins.device)
    block_sc = torch.clamp_max(
        torch.searchsorted(padded_cum, first, right=True), c2 - 1)
    # a block is live iff its first slot is (padded slots trail the live
    # ones within each supercluster's run)
    block_live = ((first < padded_cum[-1])
                  & (first - padded_base[block_sc] < count_sc[block_sc]))
    return (binned.slots, block_sc.to(torch.int32),
            block_live.to(torch.int32), overflow)


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

def _trace_pairs_batch(ps: PairScene, lanes: ct.WalkLanes, origins,
                       directions, t_min, t_max, k_cand: int):
    """One ray batch: (winner code [n] i32, MISS_CODE on a miss; best key
    [n] i32; overflow, a 0-d bool tensor)."""
    n = origins.shape[0]
    pair_ray, block_sc, block_live, overflow = bin_pairs(
        ps, origins, directions, t_min, t_max, k_cand)
    live = pair_ray >= 0
    safe_ray = torch.clamp_min(pair_ray, 0).long()

    # per-pair ray rows in pair order (one [tp, 8] row gather); dead pairs
    # get t_max = -1 so the kernel can never hit them
    rays8 = ct._pack8(origins, directions, t_min, t_max)
    dead = torch.tensor(DEAD_PAIR_ROW, device=rays8.device)
    rays8_pairs = torch.where(live[:, None], rays8[safe_ray], dead)
    keys = pair_sweep(rays8_pairs.contiguous(), block_sc, block_live,
                      ps.wald_sc, lanes=lanes)

    big = ct.MISS_CODE
    keys = torch.where(live, keys, big)
    best_key = torch.full((n,), big, dtype=torch.int32,
                          device=keys.device).scatter_reduce(
        0, safe_ray, keys, "amin")

    # winner pair -> code supercluster * W + lane = cluster * S_pad + lane
    w = ps.lanes
    pair_code = (block_sc.repeat_interleave(PAIR_P) * w
                 + (keys & _slot_mask(w)))
    win = live & (keys < big) & (keys == best_key[safe_ray])
    code = torch.full((n,), big, dtype=torch.int32,
                      device=keys.device).scatter_reduce(
        0, safe_ray, torch.where(win, pair_code, big), "amin")
    code = torch.where(best_key >= MISS_KEY, big, code)
    return code, best_key, overflow


def _trace_batches(ps: PairScene, lanes: ct.WalkLanes, origins, directions,
                   tn, tx, k_cand: int):
    """All rays in batches of min(PAIR_RAY_BATCH, n), the last padded with
    dead rays as in the JAX engine: (code [n], best key [n], overflowed)."""
    n = origins.shape[0]
    batch = min(PAIR_RAY_BATCH, n)
    pad = (-n) % batch
    o, d = origins, directions
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        tn = torch.cat([tn, tn.new_zeros(pad)])
        tx = torch.cat([tx, tx.new_full((pad,), -1.0)])
    codes, keys, overflow = [], [], []
    for s in range(0, n + pad, batch):
        sl = slice(s, s + batch)
        code, key, ovf = _trace_pairs_batch(ps, lanes, o[sl], d[sl], tn[sl],
                                            tx[sl], k_cand)
        codes.append(code)
        keys.append(key)
        overflow.append(ovf)
    return (torch.cat(codes)[:n], torch.cat(keys)[:n],
            bool(torch.stack(overflow).any()))


def closest_hit_pairs(ps: PairScene, clusters: Clusters,
                      tables: ct.WalkTables, origins: torch.Tensor,
                      directions: torch.Tensor, t_min, t_max,
                      scene_min: torch.Tensor, scene_max: torch.Tensor, *,
                      k_cand: int, fallback: bool = True
                      ) -> tuple[HitRecord, bool]:
    """Closest hit through the pair sweep, in batches of PAIR_RAY_BATCH
    rays: (HitRecord, whether some ray overlapped more than k_cand
    superclusters). With fallback, such a trace re-traces all its rays
    through the bundle engine; without it (the sweep alone, as the tests
    hold it to JAX's) the overlaps past k_cand are lost."""
    n = origins.shape[0]
    tn = ct._per_ray(t_min, n, origins)
    tx = ct._per_ray(t_max, n, origins)
    code, _, overflowed = _trace_batches(ps, tables.lanes, origins,
                                         directions, tn, tx, k_cand)
    rec = ct.hit_decode(code, None, ps.meta_rows, origins, directions, tx)
    if fallback and overflowed:
        rec, _ = ct.closest_hit_bundle(clusters, tables, origins, directions,
                                       tn, tx, scene_min, scene_max,
                                       **FALLBACK_CLOSEST)
    return rec, overflowed


def occluded_pairs(ps: PairScene, clusters: Clusters, tables: ct.WalkTables,
                   origins: torch.Tensor, directions: torch.Tensor, t_min,
                   t_max, scene_min: torch.Tensor, scene_max: torch.Tensor,
                   *, k_cand: int, fallback: bool = True
                   ) -> tuple[torch.Tensor, bool]:
    """Any-hit visibility through the pair sweep: (blocked bool [N], True
    where a triangle lies in the open segment (t_min, t_max); whether the
    trace overflowed k_cand, in which case with fallback all its rays
    re-trace through the bundle engine's any-hit walk)."""
    n = origins.shape[0]
    tn = ct._per_ray(t_min, n, origins)
    tx = ct._per_ray(t_max, n, origins)
    _, best_key, overflowed = _trace_batches(ps, tables.lanes, origins,
                                             directions, tn, tx, k_cand)
    blocked = best_key < MISS_KEY
    if fallback and overflowed:
        blocked, _ = ct.occluded_bundle(clusters, tables, origins,
                                        directions, tn, tx, scene_min,
                                        scene_max, **FALLBACK_OCCLUDED)
    return blocked, overflowed
