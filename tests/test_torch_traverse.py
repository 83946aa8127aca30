"""The bundle walks of the PyTorch port (ops/cuda_traverse.py) against the
JAX package: closest hit for both ray classes of the reference frame
(pixel tiles: presorted, interval cull; bounces: cand0 sort, exact cull),
and any hit for the DI frame's visibility rays ("shadow": presorted, exact
cull) and incoherent ones.

On the CPU the wrappers run the kernels' plain versions, so these tests
hold walk_closest_reference and walk_occluded_reference to JAX's Pallas
walks in interpret mode (bit for bit: ids, t, u, v and blocked flags), to
the brute-force oracles (exact up to t-ties), and the candidate prep to
JAX's bit for bit. The kernels themselves are compared with the plain
versions on the card only (tests/test_torch_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.ops.intersect import intersect_brute_force
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.scene import build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.wald import (
    fma, fused_hit, hit_test, ieee_fp32_matmul)
from raytracer2_tpu_torch.render import app_bridge
from raytracer2_tpu_torch.render.rays import zorder_permutation

CPU = torch.device("cpu")
P = 32  # rays per bundle
N = 96
# the two classes of the reference frame, at the shapes this scene allows
CLASSES = {
    "pixel_tiles": dict(presorted=True, cull="interval", group=4),
    "bounces": dict(presorted=False, cull="exact", group=8),
}


def _pixel_rays():
    """Camera rays through a 12x8 grid, in Z-order, as a pixel chunk."""
    zidx, _ = zorder_permutation(12, 8)
    lin = zidx.astype(np.int64)
    x = (lin % 12 + 0.5) / 12 * 3.2 - 1.6
    y = (lin // 12 + 0.5) / 8 * 2.4 - 1.2
    d = np.stack([x, y, np.full_like(x, 5.0)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32([0.11, 0.07, -5.0]), d.shape).copy()
    return o, d


def _bounce_rays():
    """Scattered origins, directions roughly toward the spheres."""
    rng = np.random.default_rng(77)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = (rng.normal(scale=0.5, size=(N, 3)) - o / 3).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    p = tmp_path_factory.mktemp("trav") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=1, lat=6, lon=8))
    j_scene = build_scene(gltf.load_file(p))
    j_clusters = jcluster.build_clusters(
        j_scene.tri_v0, j_scene.tri_edge1, j_scene.tri_edge2, cluster_size=4)
    t_clusters = convert.clusters_from_numpy(
        convert.to_numpy_tree(j_clusters), device=CPU)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    tables = ct.build_tables(t_clusters, t_scene.tri_geometry,
                             t_scene.tri_primitive)
    t_max = np.full(N, 1e5, np.float32)
    t_max[::11] = -1.0  # dead lanes, as bounce batches carry them
    rays = {"pixel_tiles": _pixel_rays(), "bounces": _bounce_rays()}
    return dict(j_scene=j_scene, j_clusters=j_clusters, t_scene=t_scene,
                t_clusters=t_clusters, tables=tables, rays=rays,
                t_min=np.full(N, 1e-3, np.float32), t_max=t_max,
                smin=np.array(jnp.min(j_clusters.aabb_min, 0)),
                smax=np.array(jnp.max(j_clusters.aabb_max, 0)))


def _port_hits(tiny, o, d, t_max=None, **kw):
    return ct.closest_hit_bundle(
        tiny["t_clusters"], tiny["tables"], torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tiny["t_min"]),
        torch.from_numpy(tiny["t_max"] if t_max is None else t_max),
        torch.from_numpy(tiny["smin"]), torch.from_numpy(tiny["smax"]),
        bundle_size=P, **kw)


def _brute(tiny, o, d):
    s = tiny["j_scene"]
    return intersect_brute_force(
        jnp.asarray(o), jnp.asarray(d), s.tri_v0, s.tri_edge1, s.tri_edge2,
        s.tri_geometry, s.tri_primitive, jnp.asarray(tiny["t_min"]),
        jnp.asarray(tiny["t_max"]))


def _assert_matches_brute(got, ref):
    """test_bvh.py's bar: the same misses and t, and the same triangle
    except where two triangles tie in t."""
    ref = convert.hit_record_from_numpy(convert.to_numpy_tree(ref),
                                        device=CPU)
    np.testing.assert_array_equal(got.missed.numpy(), ref.missed.numpy())
    m = ~ref.missed.numpy()
    np.testing.assert_allclose(got.t.numpy()[m], ref.t.numpy()[m],
                               rtol=1e-5)
    differ = (got.triangle_index != ref.triangle_index).numpy()
    np.testing.assert_allclose(got.t.numpy()[differ],
                               ref.t.numpy()[differ], rtol=1e-6)
    same = ~differ & m
    np.testing.assert_array_equal(got.geometry_index.numpy()[same],
                                  ref.geometry_index.numpy()[same])


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_walk_matches_pallas_walk_bit_exact(tiny, cls):
    cfg = CLASSES[cls]
    o, d = tiny["rays"][cls]
    s = tiny["j_scene"]
    want = ptm.closest_hit_bundle_pallas(
        tiny["j_clusters"], s.tri_geometry, s.tri_primitive,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tiny["t_min"]),
        jnp.asarray(tiny["t_max"]), jnp.asarray(tiny["smin"]),
        jnp.asarray(tiny["smax"]), bundle_size=P, interpret=True, mb=1,
        k_cand=256, **cfg)
    got, n_fallback = _port_hits(tiny, o, d, k_cand=256, **cfg)
    assert n_fallback == 0
    for f in ("triangle_index", "geometry_index", "primitive_id"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
    for f in ("t", "u", "v"):  # the decode rounds as XLA's fused affines
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (~got.missed.numpy()).sum() > N // 4  # the rays hit the spheres
    _assert_matches_brute(got, _brute(tiny, o, d))


@pytest.mark.parametrize("cls", sorted(CLASSES))
@pytest.mark.parametrize("fallback", ["partial", "full_batch"])
def test_overflow_fallback_stays_exact(tiny, cls, fallback, monkeypatch):
    """k_cand=2 truncates every bundle's candidate union: the overflowed
    bundles re-trace through the same walk at k_cand=C (partial), or the
    whole batch does once more than FALLBACK_BUNDLES overflowed."""
    o, d = tiny["rays"][cls]
    ref = _brute(tiny, o, d)
    if fallback == "full_batch":
        monkeypatch.setattr(ct, "FALLBACK_BUNDLES", 1)
    got, n_fallback = _port_hits(tiny, o, d, k_cand=2, **CLASSES[cls])
    assert 0 < n_fallback
    assert (n_fallback > ct.FALLBACK_BUNDLES) == (fallback == "full_batch")
    _assert_matches_brute(got, ref)

    bare, _ = _port_hits(tiny, o, d, k_cand=2, overflow_fallback=False,
                         **CLASSES[cls])
    assert (bare.missed.numpy() != np.asarray(ref.missed)).any(), \
        "without the fallback, k_cand=2 must miss hits (the test bites)"


def _rays_t(tiny, cls):
    o, d = tiny["rays"][cls]
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(tiny["t_min"]), torch.from_numpy(tiny["t_max"]))


def test_cand0_sort_key_bit_exact(tiny):
    o, d = tiny["rays"]["bounces"]
    c = tiny["j_clusters"]
    want = ptm._cand0_sort_key(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tiny["t_min"]),
        jnp.asarray(tiny["t_max"]), c.aabb_min, c.aabb_max,
        tiny["smin"], tiny["smax"])
    tc = tiny["t_clusters"]
    got = ct.cand0_sort_key(ct._pack8(*_rays_t(tiny, "bounces")),
                            tc.aabb_min, tc.aabb_max,
                            torch.from_numpy(tiny["smin"]),
                            torch.from_numpy(tiny["smax"]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def _assert_prep_equal(got, want, b, k, sorted_rays):
    (perm, o, d, tn, tx, cand_idx_flat, _, cand_t, cand_count, _, _, kp,
     _, overflowed) = want
    if sorted_rays:
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(perm))
    else:
        assert got.perm is None and perm is None
    n = b * P
    for g, w in ((got.o, o), (got.d, d), (got.tn, tn), (got.tx, tx)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n])
    np.testing.assert_array_equal(got.cand_idx.numpy(),
                                  np.asarray(cand_idx_flat)[:b, :k])
    np.testing.assert_array_equal(
        got.cand_t.numpy(), np.asarray(cand_t).reshape(-1, kp)[:b, :k])
    np.testing.assert_array_equal(got.cand_count.numpy(),
                                  np.asarray(cand_count)[:b])
    np.testing.assert_array_equal(got.overflowed.numpy(),
                                  np.asarray(overflowed)[:b])
    # bundles JAX adds to round its cull chunks up are empty
    assert not np.asarray(cand_count)[b:].any()


@pytest.mark.parametrize("k_cand", [8, 256])
def test_prepare_bundles_exact_bit_exact(tiny, k_cand):
    o, d = tiny["rays"]["bounces"]
    c = tiny["j_clusters"]
    want = ptm._prepare_bundles_exact(
        c, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tiny["t_min"]),
        jnp.asarray(tiny["t_max"]), tiny["smin"], tiny["smax"], P, False,
        k_cand)
    got = ct.prepare_bundles_exact(
        tiny["t_clusters"], *_rays_t(tiny, "bounces"),
        torch.from_numpy(tiny["smin"]),
        torch.from_numpy(tiny["smax"]), P, False, k_cand)
    _assert_prep_equal(got, want, N // P, min(k_cand, c.num_clusters), True)


@pytest.mark.parametrize("k_cand", [8, 256])
def test_prepare_bundles_interval_bit_exact(tiny, k_cand):
    o, d = tiny["rays"]["pixel_tiles"]
    c = tiny["j_clusters"]
    want = ptm._prepare_bundles(
        c, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tiny["t_min"]),
        jnp.asarray(tiny["t_max"]), tiny["smin"], tiny["smax"], P, True,
        k_cand=k_cand)
    got = ct.prepare_bundles_interval(tiny["t_clusters"],
                                      *_rays_t(tiny, "pixel_tiles"), P,
                                      k_cand)
    _assert_prep_equal(got, want, N // P, min(k_cand, c.num_clusters), False)


def test_make_tracers_counts_fallback_bundles(tiny, monkeypatch):
    """Tracers.fallback_bundles sums, over calls, the bundles that took the
    overflow path; the per-class shapes follow the JAX make_tracers. Tiny
    clusters and k_cand=2 make every bundle overflow."""
    monkeypatch.setattr(app_bridge, "CLUSTER_SIZE", 4)
    monkeypatch.setattr(app_bridge, "K_CAND", 2)
    tracers = app_bridge.make_tracers(tiny["t_scene"])
    assert tracers.shapes_by_class[True]["cull"] == "interval"
    assert tracers.shapes_by_class[False]["cull"] == "exact"
    assert tracers.fallback_bundles == 0
    o, d = tiny["rays"]["bounces"]
    rec = tracers.closest_hit(*_rays_t(tiny, "bounces"))
    first = tracers.fallback_bundles
    assert first > 0
    _assert_matches_brute(rec, _brute(tiny, o, d))
    tracers.closest_hit(*_rays_t(tiny, "pixel_tiles"), presorted=True)
    assert tracers.fallback_bundles > first

    brute = app_bridge.make_tracers(tiny["t_scene"], backend="brute")
    _assert_matches_brute(brute.closest_hit(*_rays_t(tiny, "bounces")),
                          _brute(tiny, o, d))
    with pytest.raises(ValueError, match="CUDA"):
        app_bridge.make_tracers(tiny["t_scene"], backend="bundle_cuda")


def test_walk_closest_dispatches_on_device(tiny, monkeypatch):
    """A CPU tensor runs the plain version; any other device launches the
    kernel or raises, and never falls back to the plain version."""
    prep = ct.prepare_bundles_exact(
        tiny["t_clusters"], *_rays_t(tiny, "bounces"),
        torch.from_numpy(tiny["smin"]),
        torch.from_numpy(tiny["smax"]), P, False, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    lanes = tiny["tables"].lanes
    launches = ct.walk_closest.launches
    code = ct.walk_closest(*args, group=8, lanes=lanes)
    assert ct.walk_closest.launches == launches  # the plain version ran
    np.testing.assert_array_equal(
        code.numpy(), ct.walk_closest_reference(*args, group=8).numpy())
    # the per-step early exit changes no result: one bundle per chunk lets
    # each bundle exit on its own
    with monkeypatch.context() as m:
        m.setitem(ct.REFERENCE_CHUNK_ELEMS, "cpu", 1)
        np.testing.assert_array_equal(
            code.numpy(), ct.walk_closest_reference(*args, group=8).numpy())
    with pytest.raises(ValueError, match="cuda or cpu"):
        ct.walk_closest(*(a.to("meta") for a in args), group=8,
                        lanes=lanes)
    with pytest.raises(TypeError):
        ct.walk_closest(rays8.double(), *args[1:], group=8, lanes=lanes)
    with pytest.raises(ValueError):
        ct.walk_closest(*args, group=16, lanes=lanes)


def test_walk_lanes_table(tiny):
    """The closest-hit kernel's lane-major table: each lane's 12 rows of
    wald_rows in LANE_ROWS order, and per cluster a lane count that covers
    every lane able to hit. Real triangles are a prefix of each cluster
    row (meta_rows' ids), so stopping at the count skips padding only."""
    tables = tiny["tables"]
    wald = tables.wald_rows
    c, _, sp = wald.shape
    lanes = tables.lanes
    assert lanes.coeffs.shape == (c, sp, 12) and lanes.count.shape == (c,)
    assert lanes.coeffs.dtype == torch.float32
    assert lanes.count.dtype == torch.int32 and lanes.coeffs.is_contiguous()
    for i, row in enumerate(ct.LANE_ROWS):
        np.testing.assert_array_equal(lanes.coeffs[:, :, i].numpy(),
                                      wald[:, row, :].numpy())
    assert sorted(ct.LANE_ROWS) == list(range(12))
    real = (tables.meta_rows[:, 12] >= 0).reshape(c, sp)
    n_real = real.sum(dim=1)
    lane = torch.arange(sp)
    assert (real == (lane[None, :] < n_real[:, None])).all()  # a prefix
    count = lanes.count.long()
    # lanes past the count hold zero rows (padding, or a degenerate real
    # triangle's zero map): d'_z == 0, never a hit
    past = lane[None, :] >= count[:, None]
    assert (wald[:, :12, :].permute(0, 2, 1)[past] == 0).all()
    assert (count <= n_real).all() and (count == n_real).float().mean() > 0.5
    # every real triangle with a nonzero map is tested
    live = (wald[:, :12, :] != 0).any(dim=1)
    assert not (live & past).any()
    assert (count < sp).all()  # 4-triangle clusters: padding is skipped
    # a table built from wald_rows alone is the same
    again = ct.walk_lanes(wald)
    np.testing.assert_array_equal(again.count.numpy(), lanes.count.numpy())
    # a cluster with no triangle tests no lane; a full one tests all
    empty = ct.walk_lanes(torch.zeros((2, 16, sp)))
    assert empty.count.tolist() == [0, 0]
    full = ct.walk_lanes(torch.ones((1, 16, sp)))
    assert full.count.tolist() == [sp]


def _tie_case(tiny, order, group):
    """One bundle whose two candidates are the same cluster's Wald rows
    under two ids, so every hit ties exactly in key across the two."""
    o, d = tiny["rays"]["pixel_tiles"]
    got, _ = _port_hits(tiny, o, d, k_cand=256, **CLASSES["pixel_tiles"])
    i = int(np.nonzero(~got.missed.numpy())[0][0])
    sp = tiny["tables"].wald_rows.shape[-1]
    code = int(torch.nonzero(
        (tiny["tables"].meta_rows[:, 12] == got.triangle_index[i]))[0])
    rows = tiny["tables"].wald_rows[code // sp]
    wald = torch.stack([rows, rows]).contiguous()
    ray = torch.tensor([*o[i], *d[i], 1e-3, 1e5], dtype=torch.float32)
    rays8 = ray.expand(P, 8).contiguous()
    cand_idx = torch.tensor([order], dtype=torch.int32)
    return ((rays8, cand_idx, torch.zeros((1, 2)),
             torch.tensor([2], dtype=torch.int32), wald),
            order[0] * sp + code % sp)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_walk_tie_rule(tiny, order, group):
    """Equal keys: inside a step the lower slot wins (the first group
    member), across steps the earlier step keeps its hit (strict <) — so
    the first candidate in walk order wins, as on the TPU."""
    args, want = _tie_case(tiny, order, group)
    np.testing.assert_array_equal(
        ct.walk_closest_reference(*args, group=group).numpy(), want)


# ---------------------------------------------------------------------------
# Any hit (the visibility rays of the DI frame)
# ---------------------------------------------------------------------------

OCCLUDE_CLASSES = {
    # pixel-Z presorted visibility rays (make_tracers' "shadow" class)
    "shadow": dict(presorted=True, group=4),
    "incoherent": dict(presorted=False, group=8),
}


@pytest.fixture(scope="module")
def shadow_rays(tiny):
    """Segments from scattered points toward scattered targets: some pass
    the sphere, some end before it, some are blocked; dead lanes too."""
    o, d = tiny["rays"]["bounces"]
    rng = np.random.default_rng(5)
    t_max = rng.uniform(0.5, 7.0, N).astype(np.float32)
    t_max[::13] = -1.0
    return o, d, t_max


def _port_occluded(tiny, o, d, t_max, **kw):
    return ct.occluded_bundle(
        tiny["t_clusters"], tiny["tables"], torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tiny["t_min"]),
        torch.from_numpy(t_max), torch.from_numpy(tiny["smin"]),
        torch.from_numpy(tiny["smax"]), bundle_size=P, **kw)


def _jax_occluded(tiny, o, d, t_max, **kw):
    return np.asarray(ptm.occluded_bundle_pallas(
        tiny["j_clusters"], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tiny["t_min"]), jnp.asarray(t_max),
        jnp.asarray(tiny["smin"]), jnp.asarray(tiny["smax"]),
        bundle_size=P, interpret=True, mb=1, cull="exact", **kw))


def _brute_occluded(tiny, o, d, t_max):
    from raytracer2_tpu.ops.intersect import occluded_brute_force as j_occl
    from raytracer2_tpu_torch.ops.intersect import occluded_brute_force

    s = tiny["j_scene"]
    want = np.asarray(j_occl(jnp.asarray(o), jnp.asarray(d), s.tri_v0,
                             s.tri_edge1, s.tri_edge2,
                             jnp.asarray(tiny["t_min"]), jnp.asarray(t_max)))
    ts = tiny["t_scene"]
    got = occluded_brute_force(torch.from_numpy(o), torch.from_numpy(d),
                               ts.tri_v0, ts.tri_edge1, ts.tri_edge2,
                               torch.from_numpy(tiny["t_min"]),
                               torch.from_numpy(t_max))
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("cls", sorted(OCCLUDE_CLASSES))
def test_occluded_walk_matches_pallas_walk_bit_exact(tiny, shadow_rays, cls):
    o, d, t_max = shadow_rays
    cfg = OCCLUDE_CLASSES[cls]
    want = _jax_occluded(tiny, o, d, t_max, k_cand=256, **cfg)
    got, n_fallback = _port_occluded(tiny, o, d, t_max, k_cand=256, **cfg)
    assert n_fallback == 0
    np.testing.assert_array_equal(got.numpy(), want)
    ref = _brute_occluded(tiny, o, d, t_max)
    np.testing.assert_array_equal(got.numpy(), ref)
    live = t_max > 0
    assert 0 < ref[live].sum() < live.sum()  # both outcomes occur
    assert not got.numpy()[~live].any()  # dead lanes are never blocked


@pytest.mark.parametrize("cls", sorted(OCCLUDE_CLASSES))
@pytest.mark.parametrize("fallback", ["partial", "full_batch"])
def test_occluded_overflow_fallback_stays_exact(tiny, shadow_rays, cls,
                                                fallback, monkeypatch):
    """k_cand=2 truncates every bundle's union: the overflowed bundles
    re-trace through the same walk at k_cand=C (partial) or the whole
    batch does (past FALLBACK_BUNDLES), bit-equal to the JAX package's
    fallback and to brute force."""
    o, d, t_max = shadow_rays
    cfg = OCCLUDE_CLASSES[cls]
    j_kw = {}
    if fallback == "full_batch":
        monkeypatch.setattr(ct, "FALLBACK_BUNDLES", 1)
        j_kw["fallback_bundles"] = 1
    got, n_fallback = _port_occluded(tiny, o, d, t_max, k_cand=2, **cfg)
    assert 0 < n_fallback
    assert (n_fallback > ct.FALLBACK_BUNDLES) == (fallback == "full_batch")
    want = _jax_occluded(tiny, o, d, t_max, k_cand=2, **cfg, **j_kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  _brute_occluded(tiny, o, d, t_max))

    bare, _ = _port_occluded(tiny, o, d, t_max, k_cand=2,
                             overflow_fallback=False, **cfg)
    assert (bare.numpy() != got.numpy()).any(), \
        "without the fallback, k_cand=2 must lose blockers (the test bites)"


def test_walk_occluded_dispatches_on_device(tiny, shadow_rays, monkeypatch):
    """A CPU tensor runs the plain version; any other device launches the
    kernel or raises. The plain version's exits (all done, candidates out,
    entry beyond every live t_max) change no result."""
    o, d, t_max = shadow_rays
    prep = ct.prepare_bundles_exact(
        tiny["t_clusters"], torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tiny["t_min"]), torch.from_numpy(t_max),
        torch.from_numpy(tiny["smin"]), torch.from_numpy(tiny["smax"]), P,
        True, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    lanes = tiny["tables"].lanes
    launches = ct.walk_occluded.launches
    got = ct.walk_occluded(*args, group=4, lanes=lanes)
    assert ct.walk_occluded.launches == launches  # the plain version ran
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), ct.walk_occluded_reference(*args, group=4).numpy())
    with monkeypatch.context() as m:
        m.setitem(ct.REFERENCE_CHUNK_ELEMS, "cpu", 1)
        np.testing.assert_array_equal(
            got.numpy(), ct.walk_occluded_reference(*args, group=4).numpy())
    # a NaN t_max of a live ray ends its bundle's walk, as the TPU's max
    nan_rays = rays8.clone()
    nan_rays[0, 7] = float("nan")
    nan_out = ct.walk_occluded_reference(nan_rays, *args[1:], group=4)
    assert not nan_out[:P].any()
    np.testing.assert_array_equal(nan_out[P:].numpy(), got[P:].numpy())
    with pytest.raises(ValueError, match="cuda or cpu"):
        ct.walk_occluded(*(a.to("meta") for a in args), group=4,
                         lanes=lanes)
    with pytest.raises(ValueError):
        ct.walk_occluded(*args, group=16, lanes=lanes)


def test_make_tracers_occluded_counts_fallback_bundles(tiny, shadow_rays,
                                                       monkeypatch):
    """Tracers.occluded per class ("shadow" presorted, incoherent sorted)
    against brute force, with the fallback bundles counted per class."""
    monkeypatch.setattr(app_bridge, "CLUSTER_SIZE", 4)
    monkeypatch.setattr(app_bridge, "K_CAND", 2)
    o, d, t_max = shadow_rays
    ref = _brute_occluded(tiny, o, d, t_max)
    rays = (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(tiny["t_min"]), torch.from_numpy(t_max))
    tracers = app_bridge.make_tracers(tiny["t_scene"])
    assert tracers.shapes_by_class["shadow"]["cull"] == "exact"
    for presorted in ("shadow", False):
        np.testing.assert_array_equal(
            tracers.occluded(*rays, presorted=presorted).numpy(), ref)
        assert tracers.fallback_by_class[presorted] > 0
    brute = app_bridge.make_tracers(tiny["t_scene"], backend="brute")
    np.testing.assert_array_equal(brute.occluded(*rays).numpy(), ref)


def _replay_occluded(args, group, lane_real, steps):
    """Per-ray replay of the any-hit walk's steps (as many per bundle as
    the walk counted): the real triangles each live ray tests, up to and
    including its first hit, and the rays that hit."""
    rays8, cand_idx, _, cand_count, wald = args
    b, sp = cand_idx.shape[0], wald.shape[-1]
    rays = rays8.reshape(b, P, 8)
    total, blocked = 0, np.zeros((b, P), bool)
    for bi in range(b):
        r = rays[bi:bi + 1]
        for k0 in range(0, int(steps[bi]) * group, group):
            ci, wr = ct._step_rows(cand_idx[bi:bi + 1], wald, k0, group)
            t, hit = hit_test(r, wr)
            hit = (hit & (t < r[..., 7:8]))[0].numpy()
            real = lane_real[ci.long()].reshape(-1).numpy()
            n_live = min(group, int(cand_count[bi]) - k0) * sp
            for i in range(P):
                if blocked[bi, i] or r[0, i, 7] <= r[0, i, 6]:
                    continue
                first = np.flatnonzero(hit[i, :n_live])
                if first.size:
                    total += int(real[:first[0] + 1].sum())
                    blocked[bi, i] = True
                else:
                    total += int(real[:n_live].sum())
    return total, blocked.reshape(-1)


@pytest.mark.parametrize("walk", ["closest", "occluded"])
def test_plain_walks_count_their_work(tiny, shadow_rays, walk):
    """lane_real changes no output and counts what the walk does
    (chip_smoke.py's bounds read it): every ray of a closest-hit bundle
    tests each real triangle (padding lanes left out) of the candidates
    its steps cover; a ray of the any-hit walk stops at its first hit, as
    a per-ray replay of the steps finds; a bundle whose rays are all
    padding takes no step."""
    o, d, t_max = shadow_rays
    t_max = t_max.copy()
    t_max[:P] = -1.0  # one bundle of padding only
    prep = ct.prepare_bundles_exact(
        tiny["t_clusters"], torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tiny["t_min"]), torch.from_numpy(t_max),
        torch.from_numpy(tiny["smin"]), torch.from_numpy(tiny["smax"]), P,
        True, 256)
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    args = (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tiny["tables"].wald_rows)
    sp = args[4].shape[-1]
    lane_real = (tiny["tables"].meta_rows[:, 12] >= 0).reshape(-1, sp)
    assert not lane_real.all()  # the clusters hold padding lanes
    fn = getattr(ct, f"walk_{walk}_reference")
    for group in (1, 4):
        out, work = fn(*args, group=group, lane_real=lane_real)
        np.testing.assert_array_equal(out.numpy(),
                                      fn(*args, group=group).numpy())
        steps = work.steps
        assert ((steps * group - prep.cand_count) < group).all()
        walked = torch.minimum(steps * group, prep.cand_count.long())
        covered = sum(int(lane_real[prep.cand_idx[i, :walked[i]].long()]
                          .sum()) for i in range(len(walked)))
        if walk == "closest":
            assert 0 < int(work.ray_lanes) == P * covered
        else:
            assert steps[0] == 0
            want, blocked = _replay_occluded(args, group, lane_real, steps)
            np.testing.assert_array_equal(blocked, out.numpy() != 0)
            assert 0 < int(work.ray_lanes) == want < P * covered


# ---------------------------------------------------------------------------
# The Wald test's rounding on the ladder (the fused multiply-adds of XLA)
# ---------------------------------------------------------------------------

LADDER_W, LADDER_H = 96, 54
# the G-buffer ray (pixel-tile order) whose hit, triangle 247339 at t 6.751,
# a Wald test rounding every product and sum on its own rejected at
# u + v = 1.0000114, leaking through to triangle 247258 at t 7.973
LEAK_RAY, LEAK_TRI = 4066, 247339


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """bench.py's ladder corridor at 96x54 seen from (0, 4, 90), through
    the port's tracers on the CPU: the G-buffer's primary rays (captured
    from gbuffer_pass) and one bounce batch drawn from their hits as
    render_reference draws it, with JAX's clusters made from the port's."""
    from raytracer2_tpu_torch.models import procedural as tproc
    from raytracer2_tpu_torch.params import default_gconst
    from raytracer2_tpu_torch.render import gbuffer as tgb
    from raytracer2_tpu_torch.render import surface as tsurf
    from raytracer2_tpu_torch.scene import gltf as tgltf
    from raytracer2_tpu_torch.scene.camera import default_camera
    from raytracer2_tpu_torch.scene.scene import build_scene as t_build
    from raytracer2_tpu_torch.utils import rng as trng

    p = tmp_path_factory.mktemp("ladder") / "ladder.glb"
    tproc.write_glb(p, tproc.corridor_glb(segments=24, pillars_per_side=12,
                                          lat=34, lon=53))
    scene = t_build(tgltf.load_file(p), device=CPU)
    tracers = app_bridge.make_tracers(scene)
    cam = default_camera(window_size=(LADDER_W, LADDER_H),
                         position=(0, 4, 90), direction=(0, 0, 1))
    g = default_gconst(cam.planar_view_constants(),
                       scene.num_emissive_triangles, enable_restir_di=1)
    calls = []

    def capture(o, d, tn, tx, presorted=False):
        hit = tracers.closest_hit(o, d, tn, tx, presorted=presorted)
        calls.append(((o, d, tn, tx), hit))
        return hit

    tgb.gbuffer_pass(scene, g, capture, LADDER_W, LADDER_H)
    ((o, d, tn, tx), hit), = calls
    surface, _ = tsurf.surface_from_hit(scene, o, d, hit)
    n = o.shape[0]
    lin = torch.arange(n)
    state = trng.init_random_sampler(lin % LADDER_W, lin // LADDER_W, 13)
    d_b, _, _ = tsurf.get_surface_brdf_sample(surface, state)
    tx_b = torch.where(hit.missed, -1.0, tx)
    c = tracers.clusters
    return dict(
        scene=scene, tracers=tracers,
        j_clusters=jcluster.Clusters(*(jnp.asarray(x.numpy()) for x in c)),
        batches={"gbuffer": (True, o, d, tn, tx),
                 "bounce": (False, surface.world_pos, d_b, tn, tx_b)},
        port={"gbuffer": hit}, jax={})


def _j(x):
    return jnp.asarray(x.numpy())


def _ladder_shapes(ladder, cls):
    """The tracers' shapes of a ray class with every cluster a candidate
    (k_cand = C): no bundle's union overflows, so JAX's walk needs no
    overflow fallback, which it would compile anew in interpret mode. (The
    port's G-buffer hits are its tracers', at k_cand 256 with the few
    overflowed bundles re-traced at k_cand = C: exact all the same, and
    cheaper than walking every bundle of a chunk to the largest union.)"""
    tr = ladder["tracers"]
    return dict(tr.shapes_by_class[cls], k_cand=tr.clusters.num_clusters)


def _ladder_closest(ladder, name):
    presorted, o, d, tn, tx = ladder["batches"][name]
    tr, s = ladder["tracers"], ladder["scene"]
    shapes = _ladder_shapes(ladder, presorted)
    if name not in ladder["jax"]:
        ladder["jax"][name] = ptm.closest_hit_bundle_pallas(
            ladder["j_clusters"], _j(s.tri_geometry), _j(s.tri_primitive),
            _j(o), _j(d), _j(tn), _j(tx), _j(tr.scene_min),
            _j(tr.scene_max), interpret=True, mb=1, presorted=presorted,
            overflow_fallback=False, **shapes)
    if name not in ladder["port"]:
        hit, n_fallback = ct.closest_hit_bundle(
            tr.clusters, tr.tables, o, d, tn, tx, tr.scene_min,
            tr.scene_max, presorted=presorted, **shapes)
        assert n_fallback == 0
        ladder["port"][name] = hit
    return ladder["port"][name], ladder["jax"][name]


@pytest.mark.parametrize("name", ["gbuffer", "bounce"])
def test_ladder_closest_hit_matches_pallas_walk_bit_exact(ladder, name):
    """The fused multiply-adds of the Wald test: on the ladder's
    G-buffer and bounce batches the port's walk returns JAX's Pallas
    walk's triangle, t, u and v on every ray."""
    got, want = _ladder_closest(ladder, name)
    for f in ("triangle_index", "geometry_index", "primitive_id"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (~got.missed).sum() > got.missed.numel() // 2


def test_ladder_leak_ray_hits(ladder):
    """Ray 4066 of the G-buffer batch hits triangle 247339 in both walks
    and in the brute-force oracle."""
    got, want = _ladder_closest(ladder, "gbuffer")
    assert int(got.triangle_index[LEAK_RAY]) == LEAK_TRI
    assert int(np.asarray(want.triangle_index)[LEAK_RAY]) == LEAK_TRI
    _, o, d, tn, tx = ladder["batches"]["gbuffer"]
    s = ladder["scene"]
    one = slice(LEAK_RAY, LEAK_RAY + 1)
    brute = intersect_brute_force(
        _j(o[one]), _j(d[one]), _j(s.tri_v0), _j(s.tri_edge1),
        _j(s.tri_edge2), _j(s.tri_geometry), _j(s.tri_primitive),
        _j(tn[one]), _j(tx[one]))
    assert int(np.asarray(brute.triangle_index)[0]) == LEAK_TRI
    np.testing.assert_allclose(float(got.t[LEAK_RAY]),
                               float(np.asarray(brute.t)[0]), rtol=1e-5)


@pytest.mark.parametrize("name", ["gbuffer", "bounce"])
def test_ladder_any_hit_matches_pallas_walk_bit_exact(ladder, name):
    """Any hit on the same rays, each segment ending at its closest hit's
    t scaled by a factor in [0.5, 1.5) (50 units where it missed): the
    blocked flags equal JAX's Pallas walk's on every ray."""
    presorted, o, d, tn, tx = ladder["batches"][name]
    hit, _ = _ladder_closest(ladder, name)
    f = np.random.default_rng(11).uniform(0.5, 1.5, o.shape[0])
    seg = torch.from_numpy(f.astype(np.float32)) * torch.where(
        hit.missed, 50.0, hit.t)
    seg = torch.where(tx < 0, tx, seg)
    tr = ladder["tracers"]
    cfg = _ladder_shapes(ladder, "shadow" if presorted else False)
    del cfg["cull"]  # the any-hit walk takes the exact cull
    got, n_fallback = ct.occluded_bundle(
        tr.clusters, tr.tables, o, d, tn, seg, tr.scene_min, tr.scene_max,
        presorted=presorted, **cfg)
    assert n_fallback == 0
    want = ptm.occluded_bundle_pallas(
        ladder["j_clusters"], _j(o), _j(d), _j(tn), _j(seg),
        _j(tr.scene_min), _j(tr.scene_max), interpret=True, mb=1,
        presorted=presorted, cull="exact", overflow_fallback=False, **cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = (seg > 0).numpy()
    assert 0 < got.numpy()[live].sum() < live.sum()


def _fma_exact(a, b, c):
    """float32(a * b + c) rounded once, to nearest and ties to even, from
    the exact rational value."""
    from fractions import Fraction

    out = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        v = Fraction(x) * Fraction(y) + Fraction(z)
        f = np.float32(float(v))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        gap = [abs(Fraction(float(q)) - v) for q in near]
        best = [q for q, e in zip(near, gap) if e == min(gap)]
        out.append(min(best, key=lambda q: int(q.view(np.int32)) & 1))
    return np.array(out, np.float32)


def test_fma_rounds_once():
    """fma is one rounding of the exact a * b + c. The first case
    sits where a float64 sum rounds onto a float32 tie: (1 + 2^-23) *
    -(1 - 2^-23) + (2^24 + 2) = 2^24 + 1 + 2^-46, whose float64 sum is the
    tie 2^24 + 1 (the 2^-46 is lost), which float32 rounds to even, 2^24,
    while the exact value rounds up to 2^24 + 2."""
    a = np.float32([1 + 2 ** -23, 1 + 2 ** -23, 3.0])
    b = np.float32([-(1 - 2 ** -23), 1 - 2 ** -23, 2 ** -30])
    c = np.float32([2 ** 24 + 2, -(2 ** 24 + 2), -2.0])
    rng = np.random.default_rng(7)
    scale = rng.choice(np.float32([1e-8, 1.0, 1e8]), 4000)
    a = np.concatenate([a, rng.normal(size=4000).astype(np.float32)])
    b = np.concatenate([b, rng.normal(size=4000).astype(np.float32)])
    c = np.concatenate([c, (rng.normal(size=4000) * scale)
                        .astype(np.float32)])
    want = _fma_exact(a, b, c)
    assert want[0] == np.float32(2 ** 24 + 2)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert twice[0] != want[0]  # the case a double rounding gets wrong
    got = fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _edge_aimed_case(seed, nb=48, p=32, w=32):
    """Rays [nb, p, 8] and Wald rows [nb, 12, 1, w] of random triangles
    (three scales). Each ray aims, with d = target - o (so t ~ 1 there), at
    one of its bundle's triangles: a vertex, a point of an edge, or a point
    inside; a quarter of the rays have t_min = 1, a tie with the aimed
    hit, the rest t_min = 0."""
    from raytracer2_tpu_torch.ops.cluster import _wald_matrices

    rng = np.random.default_rng(seed)
    t = nb * w
    scale = rng.choice([1e-2, 1.0, 50.0], (t, 1))
    v0 = rng.normal(size=(t, 3)) * 20
    e1 = rng.normal(size=(t, 3)) * scale
    e2 = rng.normal(size=(t, 3)) * scale
    m = _wald_matrices(v0, e1, e2)  # [T, 3 (u, v, z), 4 (x, y, z, bias)]
    wr = torch.from_numpy(m.transpose(0, 2, 1).reshape(nb, w, 12)
                          .transpose(0, 2, 1)[:, :, None, :].copy())
    tri = rng.integers(0, w, (nb, p)) + np.arange(nb)[:, None] * w
    a = rng.uniform(size=(nb, p, 1))
    kind = rng.integers(0, 5, (nb, p, 1))
    v0t, e1t, e2t = v0[tri], e1[tri], e2[tri]
    target = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [v0t + e1t * (kind == 0) * rng.integers(0, 2, (nb, p, 1)),
         v0t + a * e1t, v0t + a * e2t, v0t + e1t + a * (e2t - e1t)],
        v0t + a * e1t + rng.uniform(size=(nb, p, 1)) * (1 - a) * e2t)
    o = rng.normal(size=(nb, p, 3)) * 40
    r = np.zeros((nb, p, 8), np.float32)
    r[..., 0:3] = o
    r[..., 3:6] = target.astype(np.float32) - r[..., 0:3]
    r[..., 6] = np.where(rng.uniform(size=(nb, p)) < 0.25, 1.0, 0.0)
    r[..., 7] = 1e30
    return torch.from_numpy(r), wr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wald_test_matches_fused_on_every_lane(seed):
    """hit_test's float32 pass and error bound send every lane a hit
    could tip on to the fused roundings: on random rays aimed at
    triangles' vertices, edges and insides (some with t_min at the hit),
    hit equals fused_hit's on every (ray, triangle) lane bit for bit,
    and t does wherever hit is true."""
    r, wr = _edge_aimed_case(seed)
    nb, p, _ = r.shape
    w = wr.shape[-1]
    t, hit = hit_test(r, wr)
    rows = r[:, :, None, :].expand(nb, p, w, 8).reshape(-1, 8)
    coeffs = wr[:, :, 0, :].permute(0, 2, 1)[:, None].expand(
        nb, p, w, 12).reshape(-1, 12)
    t_f, hit_f = fused_hit(rows, coeffs)
    hit_f = hit_f.reshape(nb, p, w)
    np.testing.assert_array_equal(hit.numpy(), hit_f.numpy())
    np.testing.assert_array_equal(
        t[hit].numpy().view(np.int32),
        t_f.reshape(nb, p, w)[hit].numpy().view(np.int32))
    assert int(hit.sum()) > nb * p // 4
    # the cases are sharp: the test in float64 decides some lanes
    # otherwise
    f64 = [torch.from_numpy(np.asarray(x, np.float64))
           for x in (rows.numpy(), coeffs.numpy())]
    rr, cc = f64
    op = [(rr[:, 0] * cc[:, c] + rr[:, 1] * cc[:, 3 + c]
           + rr[:, 2] * cc[:, 6 + c] + cc[:, 9 + c]) for c in range(3)]
    dp = [(rr[:, 3] * cc[:, c] + rr[:, 4] * cc[:, 3 + c]
           + rr[:, 5] * cc[:, 6 + c]) for c in range(3)]
    te = -op[2] / dp[2]
    ue, ve = op[0] + te * dp[0], op[1] + te * dp[1]
    exact = ((dp[2].abs() > 1e-12) & (ue >= 0) & (ve >= 0)
             & (ue + ve <= 1) & (te > rr[:, 6]))
    assert int((exact != hit_f.reshape(-1)).sum()) > 0


@pytest.mark.parametrize("backend,value,device", [
    ("mkldnn", "bf16", "cpu"), ("mkldnn", "tf32", "cpu"),
    ("cuda", "tf32", "cuda")])
def test_wald_test_needs_ieee_matmuls(monkeypatch, backend, value, device):
    """The float32 pass's affines are batched matmuls, which hold to its
    error bound only in IEEE float32: with a device's float32 matmuls set
    to TF32 or bfloat16 the plain Wald test raises instead of answering."""
    r, wr = _edge_aimed_case(0, nb=2, p=4, w=8)
    assert ieee_fp32_matmul(torch.device(device))
    matmul = getattr(torch.backends, backend).matmul
    monkeypatch.setattr(matmul, "fp32_precision", value)
    assert not ieee_fp32_matmul(torch.device(device))
    if device == "cpu":
        with pytest.raises(RuntimeError, match="IEEE float32 matmuls"):
            hit_test(r, wr)
