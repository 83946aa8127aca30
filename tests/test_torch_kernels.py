"""The port's CUDA kernels (the closest-hit and any-hit bundle walks, and
their supercluster forms of cull="sc") against their plain torch versions,
on the card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false (a CUDA kernel has no CPU mode). The file imports no JAX, so it
also runs on a machine with an NVIDIA card and no JAX; tests/conftest.py
imports JAX, hence:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda

The tiny scene is the one tests/test_torch_traverse.py holds to JAX
(sphere_grid_glb(n=1, lat=6, lon=8), 4-triangle clusters, 32-ray bundles).
"""

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import (
    _wald_matrices as wald_matrices, build_clusters)
from raytracer2_tpu_torch.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu_torch.ops.wald import hit_test
from raytracer2_tpu_torch.render.rays import zorder_permutation
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.scene import build_scene

pytestmark = pytest.mark.cuda

P = 32  # rays per bundle
N = 96
CLASSES = {
    "pixel_tiles": dict(presorted=True, cull="interval", group=4),
    "bounces": dict(presorted=False, cull="exact", group=8),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk kernels have no CPU mode")
    return torch.device("cuda")


def _rays(cls):
    """Camera rays through a 12x8 grid in Z-order (pixel tiles), or
    scattered rays roughly toward the spheres (bounces)."""
    if cls == "pixel_tiles":
        zidx, _ = zorder_permutation(12, 8)
        lin = zidx.astype(np.int64)
        x = (lin % 12 + 0.5) / 12 * 3.2 - 1.6
        y = (lin // 12 + 0.5) / 8 * 2.4 - 1.2
        d = np.stack([x, y, np.full_like(x, 5.0)], -1).astype(np.float32)
        o = np.broadcast_to(np.float32([0.11, 0.07, -5.0]), d.shape).copy()
    else:
        rng = np.random.default_rng(77)
        o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
        d = (rng.normal(scale=0.5, size=(N, 3)) - o / 3).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def tiny(dev, tmp_path_factory):
    p = tmp_path_factory.mktemp("kernels") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=1, lat=6, lon=8))
    scene = build_scene(gltf.load_file(p), device=dev)
    clusters = build_clusters(scene.host_tri_v0, scene.host_tri_edge1,
                              scene.host_tri_edge2, cluster_size=4,
                              device=dev)
    t_max = torch.full((N,), 1e5, device=dev)
    t_max[::11] = -1.0  # dead lanes, as bounce batches carry them
    return dict(scene=scene, clusters=clusters,
                tables=ct.build_tables(clusters, scene.tri_geometry,
                                       scene.tri_primitive),
                t_min=torch.full((N,), 1e-3, device=dev), t_max=t_max)


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_kernel_matches_plain_version_on_card(dev, tiny, cls):
    """The CUDA walk against its plain version, bit for bit (chip_smoke.py
    does the same at full size)."""
    cfg = CLASSES[cls]
    c = tiny["clusters"]
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(cls))
    tn, tx = tiny["t_min"], tiny["t_max"]
    if cfg["cull"] == "interval":
        prep = ct.prepare_bundles_interval(c, o, d, tn, tx, P, 256)
    else:
        prep = ct.prepare_bundles_exact(c, o, d, tn, tx,
                                        c.aabb_min.amin(dim=0),
                                        c.aabb_max.amax(dim=0), P, False, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    launches = ct.walk_closest.launches
    got = ct.walk_closest(*args, group=cfg["group"],
                          lanes=tiny["tables"].lanes)
    torch.cuda.synchronize()
    assert ct.walk_closest.launches == launches + 1
    want = ct.walk_closest_reference(*args, group=cfg["group"])
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want != ct.MISS_CODE).sum() > N // 4  # the rays hit the spheres


def test_kernel_tie_rule_on_card(dev, tiny):
    """One bundle whose two candidates are the same cluster's Wald rows
    under two ids, so every hit ties exactly in key: the first candidate in
    walk order wins (lower slot inside a step, strict < across steps), as
    on the TPU."""
    s, tables = tiny["scene"], tiny["tables"]
    o, d = (torch.from_numpy(x).to(dev) for x in _rays("pixel_tiles"))
    hit = intersect_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2,
                                s.tri_geometry, s.tri_primitive,
                                tiny["t_min"], torch.full_like(tiny["t_max"],
                                                               1e5))
    i = int(torch.nonzero(~hit.missed)[0])
    sp = tables.wald_rows.shape[-1]
    code = int(torch.nonzero(tables.meta_rows[:, 12]
                             == hit.triangle_index[i])[0])
    rows = tables.wald_rows[code // sp]
    wald = torch.stack([rows, rows]).contiguous()
    ray = torch.cat([o[i], d[i], torch.tensor([1e-3, 1e5], device=dev)])
    rays8 = ray.expand(P, 8).contiguous()
    for group in (1, 2):
        for order in ((0, 1), (1, 0)):
            args = (rays8, torch.tensor([order], dtype=torch.int32,
                                        device=dev),
                    torch.zeros((1, 2), device=dev),
                    torch.tensor([2], dtype=torch.int32, device=dev), wald)
            got = ct.walk_closest(*args, group=group,
                                  lanes=ct.walk_lanes(wald))
            want = order[0] * sp + code % sp
            assert (got == want).all(), (group, order)
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                ct.walk_closest_reference(*args, group=group).cpu().numpy())


def _synthetic_walk(dev, p, k=16, seed=11):
    """A Wald table of 15 clusters of 128 lanes with real counts 0 to 128
    (clusters 13 and 14 copies of 1 and 4: equal keys across group members
    and steps) over random triangles in 2 < z < 10, and 6 bundles of p rays
    toward +z whose candidate lists are 0, 1, 5, 13, 15 and 16 long (no
    multiple of the group but the last), with rising entry distances up to
    20 so the early exit fires (bundles 4 and 5 end their segments at 12).
    Bundle 1 holds a ray with a NaN t_max (its walk ends at once), bundle 2
    dead rays, bundle 3 a ray with a NaN origin. Returns the walk's args
    without group."""
    rng = np.random.default_rng(seed)
    counts = [0, 128, 1, 37, 128, 77, 5, 128, 0, 100, 64, 3, 128]
    sp = 128
    wald = np.zeros((len(counts) + 2, 16, sp), np.float32)
    for ci, n in enumerate(counts):
        v0 = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                             rng.uniform(2, 10, (n, 1))], 1)
        e1, e2 = rng.normal(scale=0.8, size=(2, n, 3))
        w = wald_matrices(v0, e1, e2)  # [n, 3 outputs, 4 inputs]
        wald[ci, :12, :n] = w.transpose(2, 1, 0).reshape(12, n)
    wald[len(counts)], wald[len(counts) + 1] = wald[1], wald[4]
    nb = 6
    o = np.concatenate([rng.uniform(-1.5, 1.5, (nb * p, 2)),
                        np.zeros((nb * p, 1))], 1)
    d = np.concatenate([rng.normal(scale=0.15, size=(nb * p, 2)),
                        np.ones((nb * p, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full(nb * p, 1e-3)
    tx = np.full(nb * p, 1e5)
    o[3 * p + 3, 0] = np.nan
    tx[p + 7] = np.nan
    tx[2 * p:3 * p:3] = -1.0
    tx[4 * p:] = 12.0  # a finite bundle max: later candidates are skipped
    rays8 = np.concatenate([o, d, tn[:, None], tx[:, None]], 1)
    lists = [[], [7], [1, 13, 4, 14, 2], [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                         11, 12],
             [13, 9, 1, 14, 4, 7, 12, 3, 5, 10, 11, 0, 2, 8, 6],
             [4, 1, 14, 13, 7, 12, 9, 5, 3, 10, 11, 2, 0, 6, 8, 1]]
    cand_idx = np.zeros((nb, k), np.int32)
    cand_t = np.full((nb, k), np.inf, np.float32)
    for b, lst in enumerate(lists):
        cand_idx[b, :len(lst)] = lst
        cand_t[b, :len(lst)] = np.sort(rng.uniform(0, 20, len(lst)))
    count = np.array([len(x) for x in lists], np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        rays8.astype(np.float32), cand_idx, cand_t, count, wald))


@pytest.mark.parametrize("p,group", [(256, 4), (128, 8), (64, 1)])
def test_kernel_adversarial_cases_on_card(dev, p, group):
    """The walk kernel against its plain version, bit for bit, on clusters
    of 0 to 128 real triangles at both classes' shapes (and group 1),
    candidate lists of lengths no multiple of the group, equal keys across
    group members and steps, a NaN ray, a NaN t_max and dead rays; then
    again with each ray's t_max set to the exact t of its hit (a hit at
    t_max still wins)."""
    args = _synthetic_walk(dev, p)
    lanes = ct.walk_lanes(args[4])
    assert lanes.count.tolist()[:13] == [0, 128, 1, 37, 128, 77, 5, 128, 0,
                                         100, 64, 3, 128]
    got = ct.walk_closest(*args, group=group, lanes=lanes)
    want = ct.walk_closest_reference(*args, group=group)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    hit = want != ct.MISS_CODE
    assert hit[3 * p:].float().mean() > 0.2  # the cases bite
    assert not hit[p:2 * p].any()  # the NaN t_max ends bundle 1's walk
    # t_max at the exact t of each hit, as the plain test computes it
    rays8, wald = args[0].clone(), args[4]
    sp = wald.shape[-1]
    rows = wald[(want[hit] // sp).long(), :12, (want[hit] % sp).long()]
    t, ok = hit_test(rays8[hit][:, None, :], rows[:, :, None, None])
    assert ok.all()
    rays8[hit, 7] = t[:, 0, 0]
    args = (rays8,) + args[1:]
    got = ct.walk_closest(*args, group=group, lanes=lanes)
    want2 = ct.walk_closest_reference(*args, group=group)
    np.testing.assert_array_equal(got.cpu().numpy(), want2.cpu().numpy())
    assert (want2 != ct.MISS_CODE).sum() > p


@pytest.mark.parametrize("presorted", [True, False])
def test_occluded_kernel_matches_plain_version_on_card(dev, tiny, presorted):
    """The CUDA any-hit walk against its plain version, flag for flag, on
    segments of mixed length (some blocked, some clear, dead lanes), and
    the blocked flags against brute force."""
    c, s = tiny["clusters"], tiny["scene"]
    o, d = (torch.from_numpy(x).to(dev) for x in _rays("bounces"))
    rng = np.random.default_rng(5)
    tx = torch.from_numpy(rng.uniform(0.5, 7.0, N).astype(np.float32)).to(dev)
    tx[::13] = -1.0
    tn = tiny["t_min"]
    prep = ct.prepare_bundles_exact(c, o, d, tn, tx, c.aabb_min.amin(dim=0),
                                    c.aabb_max.amax(dim=0), P, presorted, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    for group in (1, 4, 8):
        launches = ct.walk_occluded.launches
        got = ct.walk_occluded(*args, group=group,
                               lanes=tiny["tables"].lanes)
        torch.cuda.synchronize()
        assert ct.walk_occluded.launches == launches + 1
        want = ct.walk_occluded_reference(*args, group=group)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    blocked = ct.occluded_bundle(c, tiny["tables"], o, d, tn, tx,
                                 c.aabb_min.amin(dim=0),
                                 c.aabb_max.amax(dim=0), bundle_size=P,
                                 presorted=presorted)[0]
    ref = occluded_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2, tn,
                               tx)
    np.testing.assert_array_equal(blocked.cpu().numpy(), ref.cpu().numpy())
    live = (tx > 0).cpu().numpy()
    assert 0 < ref.cpu().numpy()[live].sum() < live.sum()


def _blocking_cluster(sp=128):
    """[16, sp] Wald rows of one cluster whose single triangle spans the
    plane z = 1 over |x|, |y| < 50: every ray of _synthetic_walk's bundles
    (origins at z = 0, heading +z) crosses it."""
    w = wald_matrices(np.float64([[-50, -50, 1]]), np.float64([[150, 0, 0]]),
                      np.float64([[0, 150, 0]]))
    rows = np.zeros((16, sp), np.float32)
    rows[:12, 0] = w.transpose(2, 1, 0).reshape(12)
    return rows


@pytest.mark.parametrize("p,group", [(128, 8), (256, 4), (64, 1)])
def test_occluded_kernel_adversarial_on_card(dev, p, group):
    """The any-hit kernel against its plain version, flag for flag, on
    clusters of 0, 1 and 128 real triangles (and counts between),
    candidate lists of lengths no multiple of the group, a NaN t_max (its
    bundle's walk ends at once), a NaN origin, dead rays, a bundle whose
    first candidate blocks every ray (its walk ends at the next group
    start); then with each ray's t_max at the exact t of its closest hit
    (the open segment excludes that triangle)."""
    rays8, cand_idx, cand_t, count, wald = _synthetic_walk(dev, p)
    wald = torch.cat([wald, torch.from_numpy(_blocking_cluster()).to(dev)
                      [None]]).contiguous()
    blocker = wald.shape[0] - 1
    cand_idx, cand_t, count = cand_idx.clone(), cand_t.clone(), count.clone()
    cand_idx[0, :4] = torch.tensor([blocker, 1, 4, 7])  # bundle 0: was empty
    cand_t[0, :4] = torch.tensor([0.5, 2.0, 3.0, 4.0])
    count[0] = 4
    lanes = ct.walk_lanes(wald)
    assert lanes.count.tolist()[:13] == [0, 128, 1, 37, 128, 77, 5, 128, 0,
                                         100, 64, 3, 128]
    assert lanes.count[blocker] == 1
    args = (rays8, cand_idx, cand_t, count, wald)
    got = ct.walk_occluded(*args, group=group, lanes=lanes)
    want = ct.walk_occluded_reference(*args, group=group)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    live = (rays8[:, 7] > rays8[:, 6]).cpu()
    w = want.cpu().bool()
    assert w[:p].all()  # every ray blocked by the first candidate
    assert not w[p:2 * p].any()  # the NaN t_max ends bundle 1's walk
    assert w[3 * p:].any() and (~w[3 * p:] & live[3 * p:]).any()
    # t_max at the exact t of each ray's closest hit: a blocker exactly at
    # t_max does not block
    code = ct.walk_closest_reference(*args, group=group)
    hit = code != ct.MISS_CODE
    sp = wald.shape[-1]
    rows = wald[(code[hit] // sp).long(), :12, (code[hit] % sp).long()]
    t, ok = hit_test(rays8[hit][:, None, :], rows[:, :, None, None])
    assert ok.all()
    rays8 = rays8.clone()
    rays8[hit, 7] = t[:, 0, 0]
    args = (rays8,) + args[1:]
    got = ct.walk_occluded(*args, group=group, lanes=lanes)
    want2 = ct.walk_occluded_reference(*args, group=group)
    np.testing.assert_array_equal(got.cpu().numpy(), want2.cpu().numpy())
    assert (w & ~want2.cpu().bool()).any()  # the case bites


def _synthetic_sc_walk(dev, p, m):
    """_synthetic_walk's rays and cluster table with candidate lists of
    superclusters of m clusters (the last ones padded past the table's 15
    clusters): 6 bundles whose lists are 0, 1, 2, ... superclusters long,
    in a shuffled order, with rising entry distances."""
    rays8, _, _, _, wald = _synthetic_walk(dev, p)
    n_sc = (wald.shape[0] + m - 1) // m
    rng = np.random.default_rng(m)
    nb = 6
    cand_idx = np.zeros((nb, n_sc), np.int32)
    cand_t = np.full((nb, n_sc), np.inf, np.float32)
    count = np.minimum(np.arange(nb), n_sc).astype(np.int32)
    for b in range(nb):
        cand_idx[b, :count[b]] = rng.permutation(n_sc)[:count[b]]
        cand_t[b, :count[b]] = np.sort(rng.uniform(0, 20, count[b]))
    return (rays8,) + tuple(torch.from_numpy(x).to(dev)
                            for x in (cand_idx, cand_t, count)) + (wald,)


@pytest.mark.parametrize("walk", ["closest", "occluded"])
@pytest.mark.parametrize("p,m", [(128, 8), (256, 4), (64, 2), (128, 3)])
def test_sc_kernels_match_plain_versions_on_card(dev, walk, p, m):
    """The supercluster walks (cull="sc") against their plain versions,
    bit for bit, on _synthetic_walk's adversarial rays over superclusters
    of m of its clusters (the members past the table's 15 clusters hold
    nothing), lists of 0 to 5 superclusters; each launch counted."""
    args = _synthetic_sc_walk(dev, p, m)
    lanes = ct.walk_lanes(args[4])
    kernel = getattr(ct, f"walk_{walk}_sc")
    reference = getattr(ct, f"walk_{walk}_reference")
    launches = kernel.launches
    got = kernel(*args, group=m, lanes=lanes)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    want = reference(*args, group=m, sc_m=m)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if walk == "closest":
        assert (want[3 * p:] != ct.MISS_CODE).float().mean() > 0.2
    else:
        assert want[3 * p:].any()
