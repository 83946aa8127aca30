"""The pair-sweep engine of the PyTorch port (ops/cuda_pairs.py, and the
stable counting sort of ops/binning.py) against the JAX package's
(raytracer2_tpu/ops/pallas_pairs.py, ops/pallas_binning.py), with the Pallas
kernels in interpret mode.

On the CPU the wrappers run the kernels' plain versions, so these tests
hold pair_sweep_reference and bin_scatter_reference (through bin_pairs and
the traces) to JAX bit for bit: the pair tables, the binned layout, the
sweep's keys, whole HitRecords and blocked flags, and the probe's
checksums. One flagship frame through create_renderer(backend="pairs")
agrees with JAX's within rtol=atol=2e-3 and equals the port's bundle-walk
frame. The kernels themselves are held to the plain versions on the card
(tests/test_torch_pair_kernels.py, chip_smoke.py).

The tiny scene is tests/test_tracer_flags_fast.py's sphere (4-triangle
clusters, superclusters of 4); the frame renders the Cornell box at 16x16
from a camera off the box's axis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_binning as pbm
from raytracer2_tpu.ops import pallas_pairs as ppm
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render.app_bridge import Tracers as JTracers
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import binning
from raytracer2_tpu_torch.ops import cluster as tcluster
from raytracer2_tpu_torch.ops import cuda_pairs as cp
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops import native as tnative
from raytracer2_tpu_torch.render import app_bridge
from raytracer2_tpu_torch.render import frame as tframe

CPU = torch.device("cpu")
N = 96
GROUP = 4
PAIR_FIELDS = ("sc_min", "sc_max", "wald_sc", "meta_rows")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _rays(seed=77, n=N):
    """Scattered origins, directions roughly toward the sphere; t_max 1e5
    with every 11th ray dead (t_max = -1, as padded batches carry them)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = (rng.normal(scale=0.5, size=(n, 3)) - o / 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-3, np.float32)
    tx = np.full(n, 1e5, np.float32)
    tx[::11] = -1.0
    return o, d, tn, tx


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The sphere's SAH clusters (33 of 4 triangles), built once by the
    port and given to both packages. JAX's builder is not asked: in a fresh
    checkout its loader runs `make` into the library's own path, so a
    worker that loads while another worker's make writes the file falls
    back to a Morton build for its whole process (25 clusters), and 25
    clusters leave the groups of 5 unpadded. The port's builder renames a
    finished library into place, and SAH is required here."""
    p = tmp_path_factory.mktemp("pairs") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=1, lat=6, lon=8))
    j_scene = build_scene(gltf.load_file(p))
    assert tnative.available(), "the native SAH cluster builder must load"
    arrays = tcluster.cluster_arrays(j_scene.host_tri_v0,
                                     j_scene.host_tri_edge1,
                                     j_scene.host_tri_edge2, cluster_size=4)
    jc = jcluster.Clusters(**{f: jnp.asarray(arrays[f])
                              for f in jcluster.Clusters._fields})
    tc = tcluster.clusters_from_arrays(arrays, device=CPU)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    return dict(
        j_scene=j_scene, jc=jc, tc=tc, t_scene=t_scene,
        j_ps=ppm.build_pair_scene(jc, j_scene.tri_geometry,
                                  j_scene.tri_primitive, group=GROUP),
        t_ps=cp.build_pair_scene(tc, t_scene.tri_geometry,
                                 t_scene.tri_primitive, group=GROUP),
        tables=ct.build_tables(tc, t_scene.tri_geometry,
                               t_scene.tri_primitive),
        smin=np.array(jnp.min(jc.aabb_min, 0)),
        smax=np.array(jnp.max(jc.aabb_max, 0)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---------------------------------------------------------------------------
# Tables and binning
# ---------------------------------------------------------------------------

# 33 clusters: groups of 4 pad one cluster, groups of 5 pad two
@pytest.mark.parametrize("group", [4, 5, 16])
def test_build_pair_scene_bit_exact(tiny, group):
    s, ts = tiny["j_scene"], tiny["t_scene"]
    want = ppm.build_pair_scene(tiny["jc"], s.tri_geometry, s.tri_primitive,
                                group=group)
    got = cp.build_pair_scene(tiny["tc"], ts.tri_geometry, ts.tri_primitive,
                              group=group)
    assert tiny["jc"].num_clusters % group
    for f in PAIR_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(want, f)), err_msg=f)
    assert (got.group, got.s_pad, got.lanes, got.num_superclusters) == (
        want.group, want.s_pad, want.lanes, want.num_superclusters)
    carried = convert.pair_scene_from_numpy(convert.to_numpy_tree(want),
                                            device=CPU)
    for f in PAIR_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(carried, f).numpy()),
                                      _bits(getattr(got, f).numpy()))
    assert (carried.group, carried.s_pad) == (got.group, got.s_pad)


# 33 clusters: groups of 4 and 16 pad C with clusters, groups of 5 with two
@pytest.mark.parametrize("group", [4, 5, 16])
def test_walk_lanes_are_the_sweep_table(tiny, group):
    """The slice of the walk tables that B5 reads (WalkTables.lanes): member
    m of supercluster s is cluster s * group + m, whose lane-major
    coefficients are wald_sc's lanes m * S_pad + lane in LANE_ROWS order
    and whose lane count ends at its last nonzero lane; the members past C
    (the kernel walks min(group, C - s * group) of them) have zero rows in
    wald_sc, so they count 0 lanes."""
    ts, tc = tiny["t_scene"], tiny["tc"]
    ps = cp.build_pair_scene(tc, ts.tri_geometry, ts.tri_primitive,
                             group=group)
    lanes = tiny["tables"].lanes
    c, c2, sp = tc.num_clusters, ps.num_superclusters, ps.s_pad
    assert cp._check_lanes(lanes, ps.wald_sc) == (c, group)
    assert c2 * group > c  # some supercluster has padding members
    wald = ps.wald_sc.numpy()
    coeffs, count = lanes.coeffs.numpy(), lanes.count.numpy()
    for s in range(c2):
        for m in range(group):
            want = wald[s, list(ct.LANE_ROWS), m * sp:(m + 1) * sp].T
            if s * group + m >= c:
                assert not wald[s, :, m * sp:(m + 1) * sp].any()
                continue
            np.testing.assert_array_equal(_bits(coeffs[s * group + m]),
                                          _bits(want))
            # every lane past the count is zero (never a hit), the last
            # lane before it is not
            n = count[s * group + m]
            assert not want[n:].any() and (n == 0 or want[n - 1].any())
    # the real triangles are a prefix of each cluster row; a zero-area
    # triangle at its end has zero rows and is not counted
    real = (tc.tri_index >= 0).sum(dim=1).numpy()
    assert (count <= real).all() and (count > 0).all()


def test_build_pair_scene_keeps_the_slot_limit(tiny):
    ts = tiny["t_scene"]
    with pytest.raises(ValueError, match="11 bits"):
        cp.build_pair_scene(tiny["tc"], ts.tri_geometry, ts.tri_primitive,
                            group=17)  # 17 x 128 lanes > 2048


# k_cand 24 keeps every overlap (no overflow); 2 truncates (overflow); the
# third case has every ray dead, so every candidate is dead
BIN_CASES = {"all_kept": (24, False), "truncated": (2, False),
             "all_dead": (24, True)}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_pairs_bit_exact(tiny, case):
    k_cand, all_dead = BIN_CASES[case]
    o, d, tn, tx = _rays()
    if all_dead:
        tx[:] = -1.0
    want = ppm._bin_pairs(tiny["j_ps"], *_j(o, d, tn, tx), k_cand)
    got = cp.bin_pairs(tiny["t_ps"], *_t(o, d, tn, tx), k_cand)
    for name, g, w in zip(("pair_ray", "block_sc", "block_live", "overflow"),
                          got, want):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    pair_ray, _, block_live, overflow = got
    assert bool(overflow) == (case == "truncated")
    if all_dead:
        assert (pair_ray == -1).all() and (block_live == 0).all()
    else:
        assert (pair_ray >= 0).sum() > N // 2 and (block_live == 0).any()
        assert not np.isin(np.arange(0, N, 11), pair_ray.numpy()).any()


def _sweep_inputs(tiny, k_cand=24):
    """JAX's binned pair rows for _rays(), built as _trace_pairs_batch
    builds them."""
    o, d, tn, tx = _j(*_rays())
    pair_ray, block_sc, block_live, _ = ppm._bin_pairs(
        tiny["j_ps"], o, d, tn, tx, k_cand)
    rays8 = jnp.concatenate([o, d, tn[:, None], tx[:, None]], axis=1)
    rays8_pairs = jnp.where((pair_ray >= 0)[:, None],
                            rays8[jnp.maximum(pair_ray, 0)],
                            jnp.asarray(cp.DEAD_PAIR_ROW, jnp.float32)[None])
    return rays8_pairs, block_sc, block_live


def test_pair_sweep_plain_matches_pallas_sweep(tiny):
    """B5's plain version against _sweep_pairs in interpret mode, key for
    key, dead blocks and dead pairs included."""
    rays8_pairs, block_sc, block_live = _sweep_inputs(tiny)
    want = np.asarray(ppm._sweep_pairs(tiny["j_ps"], rays8_pairs, block_sc,
                                       block_live, interpret=True))
    got = cp.pair_sweep_reference(*_t(rays8_pairs, block_sc, block_live),
                                  tiny["t_ps"].wald_sc)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < cp.MISS_KEY).sum() > 20  # some pairs hit
    dead = np.repeat(np.asarray(block_live) == 0, cp.PAIR_P)
    assert dead.any() and (want[dead] == cp.MISS_KEY).all()


def test_pair_sweep_dispatches_on_device(tiny):
    """A CPU tensor runs the plain version (no launch counted); another
    device raises, and so do bad shapes and types."""
    args = _t(*_sweep_inputs(tiny)) + (tiny["t_ps"].wald_sc,)
    lanes = tiny["tables"].lanes
    launches = cp.pair_sweep.launches
    np.testing.assert_array_equal(cp.pair_sweep(*args, lanes=lanes).numpy(),
                                  cp.pair_sweep_reference(*args).numpy())
    assert cp.pair_sweep.launches == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        cp.pair_sweep(*(x.to("meta") for x in args),
                      lanes=ct.WalkLanes(*(x.to("meta") for x in lanes)))
    with pytest.raises(TypeError):
        cp.pair_sweep(args[0], args[1].long(), *args[2:], lanes=lanes)
    with pytest.raises(ValueError, match="must be"):
        cp.pair_sweep(args[0][:-1].contiguous(), *args[1:], lanes=lanes)
    with pytest.raises(ValueError, match="walk table"):  # clusters cut
        cp.pair_sweep(*args, lanes=ct.WalkLanes(lanes.coeffs[:-GROUP],
                                                lanes.count[:-GROUP]))


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

def _hits_equal(got, want):
    for f in ("triangle_index", "geometry_index", "primitive_id"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
    for f in ("t", "u", "v"):  # the decode rounds as XLA's fused affines
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# (k_cand, ray_batch): the sweep in one batch, in two (the second padded
# with dead rays), and with k_cand = 1, which truncates the candidates
TRACE_CASES = {"one_batch": (24, 256), "two_batches": (24, 64),
               "truncated": (1, 256)}


def _brute(tiny, o, d, tn, tx):
    s = tiny["j_scene"]
    return intersect_brute_force(*_j(o, d), s.tri_v0, s.tri_edge1,
                                 s.tri_edge2, s.tri_geometry,
                                 s.tri_primitive, *_j(tn, tx))


def _assert_matches_brute(got, ref):
    np.testing.assert_array_equal(got.missed.numpy(), np.asarray(ref.missed))
    m = ~np.asarray(ref.missed)
    assert m.sum() > N // 4  # the rays hit the sphere
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    np.testing.assert_array_equal(got.triangle_index.numpy()[m],
                                  np.asarray(ref.triangle_index)[m])


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_closest_hit_pairs_bit_exact(tiny, case, monkeypatch):
    """The whole HitRecord against JAX's with the fallback off (and so
    truncated alike at k_cand = 1), and against brute force."""
    k_cand, ray_batch = TRACE_CASES[case]
    monkeypatch.setattr(cp, "PAIR_RAY_BATCH", ray_batch)
    s = tiny["j_scene"]
    o, d, tn, tx = _rays()
    want = ppm.closest_hit_pairs(
        tiny["j_ps"], tiny["jc"], s.tri_geometry, s.tri_primitive,
        *_j(o, d, tn, tx, tiny["smin"], tiny["smax"]), k_cand=k_cand,
        ray_batch=ray_batch, interpret=True, fallback=False)
    got, overflowed = cp.closest_hit_pairs(
        tiny["t_ps"], tiny["tc"], tiny["tables"],
        *_t(o, d, tn, tx, tiny["smin"], tiny["smax"]), k_cand=k_cand,
        fallback=False)
    assert overflowed == (case == "truncated")
    _hits_equal(got, want)
    if case == "truncated":
        ref = _brute(tiny, o, d, tn, tx)
        assert (got.missed.numpy() != np.asarray(ref.missed)).any(), \
            "k_cand = 1 must lose hits without the fallback (the test bites)"
    else:
        _assert_matches_brute(got, _brute(tiny, o, d, tn, tx))


def test_closest_hit_pairs_fallback_bit_exact(tiny):
    """k_cand = 1 with the fallback: the trace overflows and re-traces
    whole through the bundle walk, which gives exactly what JAX's fallback
    branch computes (closest_hit_bundle_pallas at its defaults; mb, the
    bundles per grid step, is 1 here to keep interpret mode quick and
    changes no hit) and what brute force gives."""
    s = tiny["j_scene"]
    o, d, tn, tx = _rays()
    got, overflowed = cp.closest_hit_pairs(
        tiny["t_ps"], tiny["tc"], tiny["tables"],
        *_t(o, d, tn, tx, tiny["smin"], tiny["smax"]), k_cand=1)
    assert overflowed
    want = ptm.closest_hit_bundle_pallas(
        tiny["jc"], s.tri_geometry, s.tri_primitive,
        *_j(o, d, tn, tx, tiny["smin"], tiny["smax"]), interpret=True, mb=1)
    _hits_equal(got, want)
    _assert_matches_brute(got, _brute(tiny, o, d, tn, tx))


def test_occluded_pairs_bit_exact(tiny):
    """Blocked flags on segments of mixed length against JAX's and the
    brute-force any-hit oracle's; with k_cand = 1, truncated the same way
    as JAX's without the fallback, and exact again with it."""
    s = tiny["j_scene"]
    o, d, tn, tx = _rays(seed=78)
    rng = np.random.default_rng(9)
    tx = np.where(tx < 0, tx, rng.uniform(0.5, 6.0, N)).astype(np.float32)
    ref = np.asarray(occluded_brute_force(*_j(o, d), s.tri_v0, s.tri_edge1,
                                          s.tri_edge2, *_j(tn, tx)))
    live = tx > 0
    assert 0 < ref[live].sum() < live.sum()
    for k_cand, fallback in ((24, False), (1, False), (1, True)):
        got, overflowed = cp.occluded_pairs(
            tiny["t_ps"], tiny["tc"], tiny["tables"],
            *_t(o, d, tn, tx, tiny["smin"], tiny["smax"]), k_cand=k_cand,
            fallback=fallback)
        assert overflowed == (k_cand == 1)
        if fallback:
            np.testing.assert_array_equal(got.numpy(), ref)
            continue
        want = np.asarray(ppm.occluded_pairs(
            tiny["j_ps"], tiny["jc"],
            *_j(o, d, tn, tx, tiny["smin"], tiny["smax"]), k_cand=k_cand,
            interpret=True, fallback=False))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (k_cand == 1) == (want != ref).any()


def test_make_tracers_pairs_counts_fallback_rays(tiny, monkeypatch):
    """backend="pairs" traces through the pair sweep; with PAIR_K_CAND = 1
    every trace overflows, re-traces through the bundle walk and counts
    its rays per class. An unknown backend raises."""
    s, ts = tiny["j_scene"], tiny["t_scene"]
    rays = _rays()
    ref = intersect_brute_force(*_j(*rays[:2]), s.tri_v0, s.tri_edge1,
                                s.tri_edge2, s.tri_geometry, s.tri_primitive,
                                *_j(*rays[2:]))
    m = ~np.asarray(ref.missed)
    o, d, tn, tx = _t(*rays)
    # 4-triangle clusters, so that the sphere spans several superclusters
    monkeypatch.setattr(app_bridge, "CLUSTER_SIZE", 4)
    for k_cand, fallback in ((app_bridge.PAIR_K_CAND, {}),
                             (1, {True: N, "shadow": N})):
        monkeypatch.setattr(app_bridge, "PAIR_K_CAND", k_cand)
        tracers = app_bridge.make_tracers(ts, backend="pairs")
        assert tracers.pair_scene.num_superclusters > 1
        assert tracers.shapes_by_class is None
        hit = tracers.closest_hit(o, d, tn, tx, presorted=True)
        tracers.occluded(o, d, tn, tx, presorted="shadow")
        np.testing.assert_array_equal(hit.missed.numpy(), ~m)
        np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(ref.t)[m],
                                   rtol=1e-5)
        assert tracers.fallback_by_class == {
            **{True: 0, "shadow": 0}, **fallback}
    for backend in ("pair", "xla_bundle"):  # names no backend has
        with pytest.raises(ValueError, match="unknown backend"):
            app_bridge.make_tracers(ts, backend=backend)


# ---------------------------------------------------------------------------
# B6: the stable counting sort and the probe
# ---------------------------------------------------------------------------

def test_scatter_rate_probe_matches_jax():
    """Per block, the sum of the elements' global stable ranks (the TPU
    kernel's cursors carry over the grid)."""
    ids = np.random.default_rng(41).integers(0, 16, 4096).astype(np.int32)
    want = np.asarray(pbm.scatter_rate_probe(jnp.asarray(ids), block=1024,
                                             n_bins=16, interpret=True))
    got = binning.scatter_rate_probe(torch.from_numpy(ids), block=1024,
                                     n_bins=16)
    assert got.dtype == torch.int32 and got.shape == (4, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    per_block = [int(np.sum([np.sum(b[:i] == b[i]) for i in range(1024)]))
                 for b in ids.reshape(4, 1024)]
    assert want[1:, 0].tolist() != per_block[1:]  # global, not per block


def _numpy_counting_sort(ids, n_bins, pad, n_write, div, out_size):
    """A stable counting sort written out in numpy: (slots, counts, ranks)."""
    counts = np.zeros(n_bins, np.int64)
    ranks = np.full(ids.shape, -1, np.int64)
    for j, b in enumerate(ids):
        if 0 <= b < n_bins:
            ranks[j] = counts[b]
            counts[b] += 1
    padded = -(-counts // pad) * pad
    base = np.cumsum(padded) - padded
    slots = np.full(out_size, -1, np.int64)
    for j, b in enumerate(ids):
        if 0 <= b < n_write and base[b] + ranks[j] < out_size:
            slots[base[b] + ranks[j]] = j // div
    return slots, counts, ranks


# (seed, n_bins, pad, n_write, div): one bin; bins left empty; ids outside
# [0, n_bins); the pair engine's layout (a dead last bin, padding to 128
# slots, payload j // k)
SORT_CASES = [(1, 1, 1, 1, 1), (2, 7, 1, 7, 3), (3, 193, 128, 192, 24),
              (4, 256, 8, 256, 1), (5, 40, 128, 39, 5)]


@pytest.mark.parametrize("seed,n_bins,pad,n_write,div", SORT_CASES)
def test_bin_scatter_plain_matches_numpy_counting_sort(seed, n_bins, pad,
                                                       n_write, div):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(500, 3000))
    used = rng.choice(n_bins, size=max(1, n_bins // 2), replace=False)
    ids = used[rng.integers(0, used.size, n)].astype(np.int32)
    if seed == 4:
        ids[::17] = n_bins  # no bin: not counted, rank -1, not stored
        ids[::29] = -3
    out_size = int(-(-np.bincount(ids[(ids >= 0) & (ids < n_bins)],
                                  minlength=n_bins) // pad).sum() * pad) + 5
    want = _numpy_counting_sort(ids, n_bins, pad, n_write, div, out_size)
    got = binning.bin_scatter(torch.from_numpy(ids), n_bins, pad=pad,
                              n_write=n_write, div=div, out_size=out_size,
                              ranks=True)
    for name, g, w in zip(("slots", "counts", "ranks"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (want[1] == 0).any() == (n_bins > 1)


def test_bin_scatter_checks_its_arguments():
    ids = torch.zeros(10, dtype=torch.int32)
    launches = binning.bin_scatter.launches
    assert binning.bin_scatter(ids, 4).slots.numel() == 0
    assert binning.bin_scatter.launches == launches
    with pytest.raises(TypeError):
        binning.bin_scatter(ids.long(), 4)
    with pytest.raises(ValueError, match="n_bins"):
        binning.bin_scatter(ids, binning.MAX_BINS + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        binning.bin_scatter(ids.to("meta"), 4)


# ---------------------------------------------------------------------------
# A flagship frame through backend="pairs"
# ---------------------------------------------------------------------------

W = H = 16


def _j_pair_tracers(port_tracers, j_scene) -> JTracers:
    """JAX's pair engine (Pallas sweep in interpret mode) over the port's
    clusters, with make_tracers' settings. The Cornell box is one
    supercluster, so no ray can overflow and the fallback is left out (it
    would compile JAX's bundle walk in interpret mode for nothing); the
    segment ends go in as [n] arrays, so every trace compiles once."""
    jc = jcluster.Clusters(*(jnp.asarray(x.numpy())
                             for x in port_tracers.clusters))
    ps = ppm.build_pair_scene(jc, j_scene.tri_geometry, j_scene.tri_primitive,
                              group=app_bridge.PAIR_GROUP)
    smin = jnp.asarray(port_tracers.scene_min.numpy())
    smax = jnp.asarray(port_tracers.scene_max.numpy())

    assert ps.num_superclusters == 1

    def ends(tmin, tmax, n):
        return (jnp.broadcast_to(jnp.asarray(t, jnp.float32), (n,))
                for t in (tmin, tmax))

    def closest(o, d, tmin, tmax, presorted=False):
        return ppm.closest_hit_pairs(
            ps, jc, j_scene.tri_geometry, j_scene.tri_primitive, o, d,
            *ends(tmin, tmax, o.shape[0]), smin, smax,
            k_cand=app_bridge.PAIR_K_CAND, interpret=True, fallback=False)

    def occluded(o, d, tmin, tmax, presorted=False):
        return ppm.occluded_pairs(ps, jc, o, d, *ends(tmin, tmax, o.shape[0]),
                                  smin, smax, k_cand=app_bridge.PAIR_K_CAND,
                                  interpret=True, fallback=False)

    return JTracers(closest_hit=closest, occluded=occluded)


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and (got >= 0).all(), name
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=name)


def test_pairs_flagship_frame_matches_jax_and_the_bundle_walk(
        tmp_path_factory):
    p = tmp_path_factory.mktemp("pairs_frame") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = build_scene(gltf.load_file(p))
    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    # bench.py:266-272: the default GConst plus DI
    g = default_gconst(cam.planar_view_constants(),
                       j_scene.num_emissive_triangles, enable_restir_di=1)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_g = convert.gconst_from_numpy(convert.to_numpy_tree(g))
    t_renderer = tframe.create_renderer(t_scene, W, H, backend="pairs")
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_pair_tracers(t_renderer.tracers, j_scene))
    j_state, j_img = jframe.render_frame(j_renderer, g,
                                         jframe.init_frame_state(W, H))
    t_state, t_img = tframe.render_frame(
        t_renderer, t_g, tframe.init_frame_state(W, H, device=CPU))
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05  # lit, not black
    assert t_renderer.tracers.fallback_bundles == 0

    b_renderer = tframe.create_renderer(t_scene, W, H)
    b_state, b_img = tframe.render_frame(
        b_renderer, t_g, tframe.init_frame_state(W, H, device=CPU))
    for name, a, b in (("display", t_img, b_img),
                       ("diffuse", t_state.diffuse_lighting,
                        b_state.diffuse_lighting),
                       ("specular", t_state.specular_lighting,
                        b_state.specular_lighting)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
