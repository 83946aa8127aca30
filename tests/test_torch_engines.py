"""The XLA engines of the JAX package as torch ops in the PyTorch port:
cluster.intersect_cluster_block, the bundle engine (ops/traverse_bundle.py,
backend "bundle") and the scatter engine (ops/traverse_scatter.py, backend
"scatter"), against the JAX package's, and one small flagship frame through
each backend against JAX's frame on the same backend.

No Pallas kernel lies behind these engines, so the port has no kernel for
them: these tests hold the torch ops to JAX bit for bit (ids, t, u, v,
blocked flags, the scatter pool's overflow flag), with XLA's contraction of
the Wald affines into fused multiply-adds written out
(ops/wald.py::fma). The frames agree within rtol=atol=2e-3.

The scene is a small ladder corridor (2,906 triangles) whose SAH clusters
the port builds once and gives to both packages (JAX's builder may fall
back to a Morton build in a test worker, see tests/test_torch_pairs.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import traverse_bundle as jtb
from raytracer2_tpu.ops import traverse_scatter as jts
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render.app_bridge import Tracers as JTracers
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cluster as tcluster
from raytracer2_tpu_torch.ops import native as tnative
from raytracer2_tpu_torch.ops import traverse_bundle as tb
from raytracer2_tpu_torch.ops import traverse_scatter as ts
from raytracer2_tpu_torch.render import app_bridge
from raytracer2_tpu_torch.render import frame as tframe

CPU = torch.device("cpu")
N = 512
P = 32  # the bundle engine's rays per bundle here
SC_GROUP = 4  # clusters per supercluster of the scatter tests
W = H = 16


def _clusters(j_scene, cluster_size):
    """The port's SAH build, as both packages' Clusters."""
    arrays = tcluster.cluster_arrays(j_scene.host_tri_v0,
                                     j_scene.host_tri_edge1,
                                     j_scene.host_tri_edge2,
                                     cluster_size=cluster_size)
    jc = jcluster.Clusters(**{f: jnp.asarray(arrays[f])
                              for f in jcluster.Clusters._fields})
    return jc, tcluster.clusters_from_arrays(arrays, device=CPU)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads a test worker: the engines' plain tests are many
    small ops, which the driver's parallel workers would otherwise
    oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    p = tmp_path_factory.mktemp("engines") / "corridor.glb"
    proc.write_glb(p, proc.corridor_glb(segments=3, pillars_per_side=3,
                                        lat=8, lon=10))
    j_scene = build_scene(gltf.load_file(p))
    assert tnative.available(), "the native SAH cluster builder must load"
    jc, tc = _clusters(j_scene, 8)
    jc16, tc16 = _clusters(j_scene, 16)
    lo = j_scene.host_tri_v0.min(0)
    hi = j_scene.host_tri_v0.max(0)
    rng = np.random.default_rng(3)
    o = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full(N, 1e-3, np.float32)
    tx = np.full(N, 1e5, np.float32)
    tx[::13] = -1.0  # dead lanes
    tx[5::17] = 3.0  # short segments
    return dict(j_scene=j_scene, jc=jc, tc=tc, jc16=jc16, tc16=tc16,
                t_scene=convert.scene_from_numpy(
                    convert.to_numpy_tree(j_scene), device=CPU),
                rays=(o, d, tn, tx),
                smin=np.array(jnp.min(jc.aabb_min, 0)),
                smax=np.array(jnp.max(jc.aabb_max, 0)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


def _hits_equal(got, want):
    for f in ("t", "u", "v", "triangle_index", "geometry_index",
              "primitive_id"):
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(want, f)), err_msg=f)


def _edge_rays(corridor, n=256, seed=9):
    """Rays aimed at vertices, edge points and insides of the corridor's
    triangles (t ~ 1 at the aim), some with t_min at the aimed hit."""
    s = corridor["j_scene"]
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, s.num_triangles, n)
    v0, e1, e2 = (np.asarray(x)[tri] for x in (s.tri_v0, s.tri_edge1,
                                               s.tri_edge2))
    a = rng.uniform(size=(n, 1))
    kind = rng.integers(0, 4, (n, 1))
    target = np.select([kind == 0, kind == 1, kind == 2],
                       [v0, v0 + a * e1, v0 + e1 + a * (e2 - e1)],
                       v0 + a * 0.5 * e1 + 0.25 * e2)
    o = (target + rng.normal(size=(n, 3)) * 2).astype(np.float32)
    d = (target - o).astype(np.float32)
    tn = np.where(rng.uniform(size=n) < 0.2, 1.0, 1e-3).astype(np.float32)
    return o, d, tn, np.full(n, 1e5, np.float32)


@pytest.mark.parametrize("rays", ["random", "edge_aimed"])
def test_intersect_cluster_block_bit_exact(corridor, rays):
    """The port's intersect_cluster_block against JAX's jitted one on
    every (ray, triangle) lane of several clusters: hit, t, u and v bit
    for bit (XLA contracts each affine into fma(z, wz, fma(x, wx, y * wy))
    and u, v into fma(t, d', o'))."""
    o, d, tn, tx = (corridor["rays"] if rays == "random"
                    else _edge_rays(corridor))
    jc = corridor["jc"]
    for ci in (0, 7, jc.num_clusters // 2):
        wb = np.asarray(jc.wald)[ci]
        want = jax.jit(jcluster.intersect_cluster_block)(
            *_j(o, d, wb, tn, tx))
        got = tcluster.intersect_cluster_block(*_t(o, d, wb, tn, tx))
        for name, g, w in zip(("hit", "t", "u", "v"), got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                          err_msg=name)
    # batched over leading dimensions, as JAX's vmap of it
    wb = np.asarray(jc.wald)[:3]
    want = jax.jit(jax.vmap(jcluster.intersect_cluster_block))(
        *_j(*(np.broadcast_to(x, (3,) + x.shape) for x in (o, d)), wb,
            *(np.broadcast_to(x, (3,) + x.shape) for x in (tn, tx))))
    got = tcluster.intersect_cluster_block(
        *_t(o, d), torch.from_numpy(wb), *_t(tn, tx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def _bundle_args(corridor):
    o, d, tn, tx = corridor["rays"]
    return (_j(o, d, tn, tx, corridor["smin"], corridor["smax"]),
            _t(o, d, tn, tx, corridor["smin"], corridor["smax"]))


@pytest.mark.parametrize("sort_rays,ray_batch", [(False, tb.RAY_BATCH),
                                                 (True, tb.RAY_BATCH),
                                                 (True, 128)])
def test_bundle_engine_bit_exact(corridor, sort_rays, ray_batch):
    """closest_hit_bundle and occluded_bundle against JAX's XLA engine:
    whole HitRecords and blocked flags bit for bit, unsorted, sorted by
    the coherence key, and sliced into several ray batches (bundles sorted
    by candidate count; JAX's own slicing at its ray_batch)."""
    j_args, t_args = _bundle_args(corridor)
    s, t_scene = corridor["j_scene"], corridor["t_scene"]

    @jax.jit
    def j_closest(*a):
        return jtb._trace_batched(a[0], a[1], a[2], a[3], corridor["jc"],
                                  jtb.MAX_CANDIDATES, P, False,
                                  ray_batch=ray_batch)

    want = jtb.closest_hit_bundle(corridor["jc"], s.tri_geometry,
                                  s.tri_primitive, *j_args, bundle_size=P,
                                  sort_rays=sort_rays)
    stats = tb.WalkStats()
    got = tb.closest_hit_bundle(corridor["tc"], t_scene.tri_geometry,
                                t_scene.tri_primitive, *t_args,
                                bundle_size=P, sort_rays=sort_rays,
                                ray_batch=ray_batch, stats=stats)
    if ray_batch == tb.RAY_BATCH:
        _hits_equal(got, want)
    else:  # the sliced dispatch itself, unsorted rays against unsorted
        bt, u, v, tri, _ = j_closest(*j_args[:4])
        port = tb._trace_batched(*t_args[:4], corridor["tc"], P, False,
                                 ray_batch=ray_batch)
        for name, g, w in zip(("t", "u", "v", "tri"), port, (bt, u, v, tri)):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                          err_msg=name)
        _hits_equal(got, want)  # the sorted trace at JAX's batch size
    hits = int((got.triangle_index >= 0).sum())
    assert N // 4 < hits < N
    assert stats.calls >= 1 and stats.host_checks == stats.steps + stats.calls

    blocked = tb.occluded_bundle(corridor["tc"], *t_args, bundle_size=P,
                                 sort_rays=sort_rays, ray_batch=ray_batch)
    want_b = jtb.occluded_bundle(corridor["jc"], *j_args, bundle_size=P,
                                 sort_rays=sort_rays)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(want_b))
    assert 0 < int(blocked.sum()) < N


def test_sort_rays_for_coherence_bit_exact(corridor):
    o, d, _, _ = corridor["rays"]
    want = jtb.sort_rays_for_coherence(*_j(o, d, corridor["smin"],
                                           corridor["smax"]))
    got = tb.sort_rays_for_coherence(*_t(o, d, corridor["smin"],
                                         corridor["smax"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def superclusters(corridor):
    return (jts.build_superclusters(corridor["jc16"], group=SC_GROUP),
            ts.build_superclusters(corridor["tc16"], group=SC_GROUP))


def test_build_superclusters_bit_exact(superclusters):
    want, got = superclusters
    for name, g, w in zip(ts.SuperClusters._fields, got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=name)
    assert got.num_superclusters == want.num_superclusters > 16


@pytest.mark.parametrize("avg_candidates", [ts.AVG_CANDIDATES, 2])
def test_scatter_engine_bit_exact(corridor, superclusters, avg_candidates):
    """closest_hit_scatter and occluded_scatter against JAX's scatter
    engine: HitRecords and blocked flags bit for bit, and the overflow
    flag as JAX's _trace_scatter_batch reports it; avg_candidates=2 forces
    the overflow (rays overlapping more than 2 superclusters drop pairs:
    both engines then miss the same hits)."""
    j_sc, t_sc = superclusters
    o, d, tn, tx = corridor["rays"]
    s, t_scene = corridor["j_scene"], corridor["t_scene"]
    want = jts.closest_hit_scatter(j_sc, s.tri_geometry, s.tri_primitive,
                                   *_j(o, d, tn, tx),
                                   avg_candidates=avg_candidates)
    got, overflowed = ts.closest_hit_scatter(
        t_sc, t_scene.tri_geometry, t_scene.tri_primitive, *_t(o, d, tn, tx),
        avg_candidates=avg_candidates)
    _hits_equal(got, want)
    j_ovf = jax.jit(lambda *a: jts._trace_scatter_batch(
        *a, j_sc, avg_candidates, False)[3])(*_j(o, d, tn, tx))
    assert bool(overflowed) == bool(j_ovf) == (avg_candidates == 2)

    blocked, overflowed_b = ts.occluded_scatter(
        t_sc, *_t(o, d, tn, tx), avg_candidates=avg_candidates)
    want_b = jts.occluded_scatter(j_sc, *_j(o, d, tn, tx),
                                  avg_candidates=avg_candidates)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(want_b))
    assert bool(overflowed_b) == bool(overflowed)
    hits = int((got.triangle_index >= 0).sum())
    assert 0 < hits < N and 0 < int(blocked.sum()) < N
    if avg_candidates == 2:  # the flag reports real losses
        full, _ = ts.closest_hit_scatter(
            t_sc, t_scene.tri_geometry, t_scene.tri_primitive,
            *_t(o, d, tn, tx))
        assert (full.triangle_index >= 0).sum() > hits


def test_scatter_engine_batches_bit_exact(corridor, superclusters):
    """Several ray batches (the last one padded) give the one-batch
    answer."""
    _, t_sc = superclusters
    o, d, tn, tx = corridor["rays"]
    t_scene = corridor["t_scene"]
    one, _ = ts.closest_hit_scatter(t_sc, t_scene.tri_geometry,
                                    t_scene.tri_primitive, *_t(o, d, tn, tx))
    many, _ = ts.closest_hit_scatter(t_sc, t_scene.tri_geometry,
                                     t_scene.tri_primitive,
                                     *_t(o, d, tn, tx), ray_batch=200)
    _hits_equal(many, one)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _j_engine_tracers(backend, port_tracers, j_scene) -> JTracers:
    """JAX's engine over the port's clusters, with make_tracers'
    settings (the coherence sort on every batch for "bundle")."""
    jc = jcluster.Clusters(*(jnp.asarray(x.numpy())
                             for x in port_tracers.clusters))
    if backend == "bundle":
        smin = jnp.asarray(port_tracers.scene_min.numpy())
        smax = jnp.asarray(port_tracers.scene_max.numpy())

        def closest(o, d, tmin, tmax, presorted=False):
            return jtb.closest_hit_bundle(
                jc, j_scene.tri_geometry, j_scene.tri_primitive, o, d, tmin,
                tmax, smin, smax, sort_rays=True)

        def occluded(o, d, tmin, tmax, presorted=False):
            return jtb.occluded_bundle(jc, o, d, tmin, tmax, smin, smax,
                                       sort_rays=True)
    else:
        sc = jts.build_superclusters(jc, group=app_bridge.SCATTER_GROUP)

        def closest(o, d, tmin, tmax, presorted=False):
            return jts.closest_hit_scatter(
                sc, j_scene.tri_geometry, j_scene.tri_primitive, o, d, tmin,
                tmax)

        def occluded(o, d, tmin, tmax, presorted=False):
            return jts.occluded_scatter(sc, o, d, tmin, tmax)
    return JTracers(closest_hit=closest, occluded=occluded)


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and (got >= 0).all(), name
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("backend", ["bundle", "scatter"])
def test_engine_flagship_frame_matches_jax(corridor, backend):
    """One 16x16 flagship frame (the default GConst plus DI, GI on) of the
    corridor through create_renderer(backend=...) against JAX's frame
    through the same engine over the same clusters, within 2e-3; the
    scatter pool never overflows here."""
    j_scene, t_scene = corridor["j_scene"], corridor["t_scene"]
    cam = default_camera(window_size=(W, H), position=(0.13, 3.07, 11.5),
                         direction=(0, 0, 1))
    g = default_gconst(cam.planar_view_constants(),
                       j_scene.num_emissive_triangles, enable_restir_di=1)
    t_g = convert.gconst_from_numpy(convert.to_numpy_tree(g))
    t_renderer = tframe.create_renderer(t_scene, W, H, backend=backend)
    tracers = t_renderer.tracers
    assert tracers.clusters.cluster_size == (64 if backend == "bundle"
                                             else 16)
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_engine_tracers(backend, tracers, j_scene))
    j_state, j_img = jframe.render_frame(j_renderer, g,
                                         jframe.init_frame_state(W, H))
    t_state, t_img = tframe.render_frame(
        t_renderer, t_g, tframe.init_frame_state(W, H, device=CPU))
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05  # lit, not black
    if backend == "scatter":
        assert sum(tracers.overflow_by_class.values()) == 0
    else:
        assert tracers.walk_stats.calls > 0
