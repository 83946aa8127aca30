"""The function-level knobs of the bundle walk and the reference frame in
the PyTorch port against the JAX package: closest_hit_bundle's and
occluded_bundle's debug_steps, t_cap, lean, depth, mb and mm (JAX's
closest_hit_bundle_pallas and occluded_bundle_pallas in interpret mode),
render_reference's compact_dead_lanes and textures_enabled,
render_reference_jit, compile_cache, build_clusters(method=) and
OnionLayout.outer_radius.

The scene is one tessellated sphere (sphere_grid_glb(n=1, lat=6, lon=8))
in 4-triangle clusters that the port builds and gives to both packages;
512 rays start around it, most aimed at it, some dead, some short, in
bundles of 32, with k_cand 8 so that some bundles overflow. JAX is imported
inside the fixtures that call it, so the `cuda`-marked tests (each kernel
instance against its plain version) run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_knobs.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch import compile_cache
from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.ops import cluster as tcluster
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops import cull
from raytracer2_tpu_torch.ops import native as tnative
from raytracer2_tpu_torch.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.scene import build_scene

CPU = torch.device("cpu")
N = 512
P = 32
K_CAND = 8
GROUP = 2  # up to 4 steps a bundle at k_cand 8
T_MAX, SHORT = 1e5, 3.0  # closest-hit and visibility segments

FIELDS = ("triangle_index", "geometry_index", "primitive_id", "t", "u", "v")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads a test worker: the plain walks are many small ops,
    which the driver's parallel workers would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rays(seed=77, n=N):
    """Rays around the sphere, most aimed at it: o, d [n, 3], t_min, t_max
    [n] (every 11th dead), as numpy float32."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = (rng.uniform(-0.8, 0.8, (n, 3)) - o).astype(np.float32)
    d[::7] = rng.normal(size=(len(d[::7]), 3))  # some look anywhere
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-3, np.float32)
    tx = np.full(n, T_MAX, np.float32)
    tx[::11] = -1.0
    return o, d, tn, tx


def _scene(tmp_path_factory, dev):
    p = tmp_path_factory.mktemp("knobs") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=1, lat=6, lon=8))
    model = gltf.load_file(p)
    scene = build_scene(model, device=dev)
    arrays = tcluster.cluster_arrays(scene.host_tri_v0, scene.host_tri_edge1,
                                     scene.host_tri_edge2, cluster_size=4)
    clusters = tcluster.clusters_from_arrays(arrays, device=dev)
    tables = ct.build_tables(clusters, scene.tri_geometry,
                             scene.tri_primitive)
    return model, scene, arrays, clusters, tables


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    model, scene, arrays, clusters, tables = _scene(tmp_path_factory, CPU)
    o, d, tn, tx = (torch.from_numpy(x) for x in _rays())
    return dict(model=model, scene=scene, arrays=arrays, clusters=clusters,
                tables=tables, rays=(o, d, tn, tx),
                smin=clusters.aabb_min.amin(dim=0),
                smax=clusters.aabb_max.amax(dim=0))


def _closest(tiny, tx=None, **kw):
    o, d, tn, tx0 = tiny["rays"]
    return ct.closest_hit_bundle(
        tiny["clusters"], tiny["tables"], o, d, tn,
        tx0 if tx is None else tx, tiny["smin"], tiny["smax"],
        bundle_size=P, group=GROUP, k_cand=K_CAND, **kw)


def _occluded(tiny, **kw):
    o, d, tn, tx = tiny["rays"]
    tx = torch.where(tx > 0, SHORT, tx)
    return ct.occluded_bundle(
        tiny["clusters"], tiny["tables"], o, d, tn, tx, tiny["smin"],
        tiny["smax"], bundle_size=P, group=GROUP, k_cand=K_CAND, **kw)


def _assert_rec_equal(got, want):
    for f in FIELDS:
        g = np.asarray(getattr(got, f))
        w = np.asarray(getattr(want, f))
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)


# JAX's calls: (query, knobs), each one interpret-mode compile (mb=1 unless
# the knob is mb; debug_steps and overflow_fallback=False take no fallback)
JAX_CALLS = {
    "closest_lean_depth": ("closest", dict(debug_steps=True, lean=True,
                                           depth=1)),
    "closest_cap_mb": ("closest", dict(debug_steps=True, t_cap=True,
                                       mb=2)),
    "closest_mm": ("closest", dict(mm=True, overflow_fallback=False)),
    "occluded_depth": ("occluded", dict(debug_steps=True, depth=1)),
    "occluded_cap_mb": ("occluded", dict(debug_steps=True, t_cap=True,
                                         mb=2)),
    "occluded_mm": ("occluded", dict(mm=True, overflow_fallback=False)),
}


@pytest.fixture(scope="module")
def jax_walks(tiny):
    """JAX's Pallas walks in interpret mode over the port's clusters, one
    call each of JAX_CALLS."""
    import jax.numpy as jnp

    from raytracer2_tpu.ops import cluster as jcluster
    from raytracer2_tpu.ops import pallas_traverse as ptm

    jc = jcluster.Clusters(**{f: jnp.asarray(tiny["arrays"][f])
                              for f in jcluster.Clusters._fields})
    o, d, tn, tx = (jnp.asarray(x.numpy()) for x in tiny["rays"])
    smin, smax = (jnp.asarray(x.numpy()) for x in (tiny["smin"],
                                                   tiny["smax"]))
    geom = jnp.asarray(tiny["scene"].tri_geometry.numpy())
    prim = jnp.asarray(tiny["scene"].tri_primitive.numpy())
    out = {}
    for name, (query, knobs) in JAX_CALLS.items():
        kw = dict(bundle_size=P, interpret=True, group=GROUP, k_cand=K_CAND,
                  mb=1)
        kw.update(knobs)
        if query == "closest":
            out[name] = ptm.closest_hit_bundle_pallas(
                jc, geom, prim, o, d, tn, tx, smin, smax, **kw)
        else:
            out[name] = ptm.occluded_bundle_pallas(
                jc, o, d, tn, jnp.where(tx > 0, SHORT, tx), smin, smax,
                **kw)
    return out


def _port_call(tiny, name):
    query, knobs = JAX_CALLS[name]
    return (_closest if query == "closest" else _occluded)(tiny, **knobs)


@pytest.mark.parametrize("name", [n for n in JAX_CALLS if "mm" not in n])
def test_knobs_match_pallas_walks_bit_exact(tiny, jax_walks, name):
    """debug_steps (with and without t_cap, closest and any hit), lean,
    depth and mb through the plain walks against JAX's Pallas walks with
    the same knobs: the hit record (or blocked flags), each bundle's steps
    and candidate count and the overflow flag bit for bit."""
    got, info = _port_call(tiny, name)
    want, w_info = jax_walks[name]
    if isinstance(want, torch.Tensor) or not hasattr(want, "t"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < N
    else:
        _assert_rec_equal(got, want)
        assert N // 4 < int((~got.missed).sum()) < N
    b = info["steps"].shape[0]
    np.testing.assert_array_equal(info["steps"].numpy(),
                                  np.asarray(w_info["steps"])[:b])
    np.testing.assert_array_equal(info["cand_count"].numpy(),
                                  np.asarray(w_info["cand_count"])[:b])
    assert bool(info["overflowed"]) == bool(w_info["overflowed"])
    assert int(info["steps"].sum()) > b and bool(info["overflowed"])


def test_steps_with_t_cap_never_exceed_steps_without(tiny):
    """t_cap only lowers t_max, so no bundle takes more walk steps."""
    for query in (_closest, _occluded):
        _, plain = query(tiny, debug_steps=True)
        _, capped = query(tiny, debug_steps=True, t_cap=True)
        assert (capped["steps"] <= plain["steps"]).all()


@pytest.mark.parametrize("knobs", [
    dict(lean=True), dict(depth=1), dict(depth=2), dict(depth=3),
    dict(mb=2), dict(mb=3), dict(t_cap=True), dict(lean=True, t_cap=True)])
def test_knobs_give_the_default_hits(tiny, knobs):
    """Every knob that changes no hit, through the overflow fallback (k_cand
    8 overflows), against the default trace: hit records and blocked flags
    bit for bit; t_cap's against the brute-force oracle too."""
    want, n_ovf = _closest(tiny)
    got, n = _closest(tiny, **knobs)
    assert n == n_ovf > 0
    _assert_rec_equal(got, want)
    if "lean" not in knobs:
        want_b, _ = _occluded(tiny)
        got_b, _ = _occluded(tiny, **knobs)
        np.testing.assert_array_equal(got_b.numpy(), want_b.numpy())
    if knobs.get("t_cap"):
        s = tiny["scene"]
        o, d, tn, tx = tiny["rays"]
        ref = intersect_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2,
                                    s.tri_geometry, s.tri_primitive, tn, tx)
        np.testing.assert_array_equal(got.missed.numpy(), ref.missed.numpy())
        np.testing.assert_array_equal(got.triangle_index.numpy(),
                                      ref.triangle_index.numpy())
        # the walk's Wald t against Moller-Trumbore's
        np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5)
        if "lean" not in knobs:
            blocked = occluded_brute_force(
                o, d, s.tri_v0, s.tri_edge1, s.tri_edge2, tn,
                torch.where(tx > 0, SHORT, tx))
            np.testing.assert_array_equal(got_b.numpy(), blocked.numpy())


@pytest.mark.parametrize("presorted", [False, True])
def test_t_cap_prep_matches_jax_prep_bit_exact(tiny, presorted):
    """The exact cull's prep with t_cap against JAX's jitted
    _prepare_bundles_exact(t_cap=True): the capped t_max (B4's cap, then
    apply_t_cap's fused multiply-add), the candidates and the counts bit
    for bit; rays that overlap nothing clamp to -1, never NaN."""
    import functools

    import jax
    import jax.numpy as jnp

    from raytracer2_tpu.ops import cluster as jcluster
    from raytracer2_tpu.ops import pallas_traverse as ptm

    jc = jcluster.Clusters(**{f: jnp.asarray(tiny["arrays"][f])
                              for f in jcluster.Clusters._fields})
    args = tiny["rays"] + (tiny["smin"], tiny["smax"])
    want = jax.jit(functools.partial(
        ptm._prepare_bundles_exact, bundle_size=P, presorted=presorted,
        k_cand=K_CAND, t_cap=True))(jc, *(jnp.asarray(x.numpy())
                                          for x in args))
    got = ct._prepare(tiny["clusters"], *args, P, presorted, "exact", K_CAND,
                      t_cap=True)
    _, _, _, _, tx, cand_idx_flat, _, _, cand_count, _, _, _, t_max, _ = want
    np.testing.assert_array_equal(got.tx.numpy().view(np.int32),
                                  np.asarray(tx)[:N].view(np.int32))
    b, k = got.cand_idx.shape
    np.testing.assert_array_equal(got.cand_idx.numpy(),
                                  np.asarray(cand_idx_flat)[:b, :k])
    np.testing.assert_array_equal(got.cand_count.numpy(),
                                  np.asarray(cand_count)[:b])
    capped = got.tx[got.tx >= 0]
    assert not torch.isnan(got.tx).any()
    assert (got.tx == -1.0).sum() > N // 11  # dead, and overlapping nothing
    assert (capped < T_MAX).all() and capped.numel() > N // 4


def test_mm_matches_pallas_mm_and_the_oracle(tiny, jax_walks):
    """mm=True (the plain version of the tensor-core form, float32
    matrix products) against JAX's mm=True (no fallback) and, with the
    fallback, the brute-force oracle: missed flags and triangle ids equal,
    t within 1e-6 relative of JAX's (the walk's decoded t against
    Moller-Trumbore's within 1e-5); blocked flags equal."""
    s = tiny["scene"]
    o, d, tn, tx = tiny["rays"]
    got, _ = _closest(tiny, mm=True, overflow_fallback=False)
    want = jax_walks["closest_mm"]
    ref, _ = _closest(tiny)  # the default trace: the oracle's hits
    oracle = intersect_brute_force(o, d, s.tri_v0, s.tri_edge1, s.tri_edge2,
                                   s.tri_geometry, s.tri_primitive, tn, tx)
    np.testing.assert_array_equal(ref.triangle_index.numpy(),
                                  oracle.triangle_index.numpy())
    full, _ = _closest(tiny, mm=True)
    np.testing.assert_array_equal(full.triangle_index.numpy(),
                                  oracle.triangle_index.numpy())
    np.testing.assert_array_equal(got.missed.numpy(),
                                  np.asarray(want.missed))
    np.testing.assert_array_equal(got.triangle_index.numpy(),
                                  np.asarray(want.triangle_index))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    np.testing.assert_allclose(full.t.numpy(), oracle.t.numpy(), rtol=1e-5)
    blocked, _ = _occluded(tiny, mm=True, overflow_fallback=False)
    np.testing.assert_array_equal(blocked.numpy(),
                                  np.asarray(jax_walks["occluded_mm"]))
    assert 0 < int(blocked.sum()) < N


def test_debug_steps_count_groups_not_clusters(tiny):
    """A step is a group of `group` candidates: at group 1 the same walk
    takes at least as many steps as at group 4, and each bundle's steps
    stay within ceil(cand_count / group)."""
    for group in (1, 4):
        o, d, tn, tx = tiny["rays"]
        _, info = ct.closest_hit_bundle(
            tiny["clusters"], tiny["tables"], o, d, tn, tx, tiny["smin"],
            tiny["smax"], bundle_size=P, group=group, k_cand=K_CAND,
            debug_steps=True)
        ceil = (info["cand_count"] + group - 1) // group
        assert (info["steps"] <= ceil).all()
        if group == 1:
            steps_1 = info["steps"]
    assert (steps_1 >= info["steps"]).all() and (steps_1 > info["steps"]).any()


# ---------------------------------------------------------------------------
# The reference frame, the build cache, the cluster build, ReGIR
# ---------------------------------------------------------------------------

REF_W, REF_H = 64, 32  # 2,048 lanes: the smallest batch that compacts


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    """Two of four spheres emissive over a floor (the port's scene and the
    model for JAX's)."""
    p = tmp_path_factory.mktemp("lit") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=2, lat=6, lon=8,
                                           emissive_every=2))
    model = gltf.load_file(p)
    return model, build_scene(model, device=CPU)


@pytest.fixture(scope="module")
def reference_frames(lit):
    """The spheres seen from afar at 64x32 (most primary rays escape), 3
    bounces, 1 sample: the port's frame with and without compaction
    (counting the lanes of each trace) and JAX's compacted frame, both with
    textures_enabled=False."""
    import jax.numpy as jnp

    from raytracer2_tpu.params import default_gconst as j_gconst
    from raytracer2_tpu.render import reference as jref
    from raytracer2_tpu.scene.camera import default_camera as j_camera
    from raytracer2_tpu.scene.scene import build_scene as j_build_scene
    from raytracer2_tpu_torch.params import default_gconst
    from raytracer2_tpu_torch.render import reference as tref
    from raytracer2_tpu_torch.scene.camera import default_camera

    cam = dict(window_size=(REF_W, REF_H), position=(0.3, 1.5, -14.0),
               direction=(0, 0, -1))
    model, t_scene = lit
    g = default_gconst(default_camera(**cam).planar_view_constants(),
                       t_scene.num_emissive_triangles, refrence_mode=1)
    kw = dict(max_bounces=3, max_samples=1, textures_enabled=False)
    lanes = []
    brute = tref.make_brute_force_tracer(t_scene)

    def trace(o, d, tn, tx, presorted=False):
        lanes.append(o.shape[0])
        return brute(o, d, tn, tx, presorted=presorted)

    plain = tref.render_reference(t_scene, g, REF_W, REF_H, **kw)
    compact = tref.render_reference(t_scene, g, REF_W, REF_H, trace_fn=trace,
                                    compact_dead_lanes=True, **kw)
    j_scene = j_build_scene(model)
    jg = j_gconst(j_camera(**cam).planar_view_constants(),
                  j_scene.num_emissive_triangles, refrence_mode=1)
    want = np.asarray(jref.render_reference(
        j_scene, jg, REF_W, REF_H, compact_dead_lanes=True, **kw))
    assert jnp.isfinite(want).all()
    return plain, compact, want, lanes


def test_compact_dead_lanes_is_bit_identical(reference_frames):
    """compact_dead_lanes traces the live half of each bounce batch whose
    lanes are at most half live (the primaries of a far sphere mostly
    escape), and the frame equals the uncompacted one bit for bit and JAX's
    compacted frame within 1e-6."""
    plain, compact, want, lanes = reference_frames
    n = REF_W * REF_H
    assert lanes[0] == n and (n // 2) in lanes[1:]  # the half branch ran
    np.testing.assert_array_equal(compact.numpy().view(np.int32),
                                  plain.numpy().view(np.int32))
    np.testing.assert_allclose(compact.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (compact.numpy() > 0).any()


def test_render_reference_jit_matches_jax(lit):
    """render_reference_jit (one call of render_reference through the
    brute-force tracer) against JAX's jitted one, within 1e-6; and
    textures_enabled=None reads g_const.textures. (JAX's jitted function
    traces only with g_const.textures 0: with it set, `textures_enabled
    and scene.has_textures` converts a traced leaf of Scene to bool.)"""
    import jax.numpy as jnp

    from raytracer2_tpu.params import default_gconst as j_gconst
    from raytracer2_tpu.render import reference as jref
    from raytracer2_tpu.scene.camera import default_camera as j_camera
    from raytracer2_tpu.scene.scene import build_scene as j_build_scene
    from raytracer2_tpu_torch.params import default_gconst
    from raytracer2_tpu_torch.render import reference as tref
    from raytracer2_tpu_torch.scene.camera import default_camera

    model, t_scene = lit
    w, h = 16, 16
    cam = dict(window_size=(w, h), position=(0.3, 1.5, -6.0),
               direction=(0, 0, -1))
    g = default_gconst(default_camera(**cam).planar_view_constants(),
                       t_scene.num_emissive_triangles, refrence_mode=1,
                       textures=0)
    got = tref.render_reference_jit(t_scene, g, w, h, 2, 1)
    j_scene = j_build_scene(model)
    jg = j_gconst(j_camera(**cam).planar_view_constants(),
                  j_scene.num_emissive_triangles, refrence_mode=1,
                  textures=0)
    want = np.asarray(jref.render_reference_jit(j_scene, jg, w, h, 2, 1))
    assert jnp.isfinite(want).all() and (want > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    both = tref.render_reference(t_scene, g, w, h, 2, 1,
                                 textures_enabled=False)
    np.testing.assert_array_equal(both.numpy(), got.numpy())


def test_compile_cache_builds_into_the_directory_given(tmp_path, monkeypatch):
    """enable_compile_cache(dir) points the native builder (and the kernel
    library) at dir/native and dir/kernels: the builder's library lands
    there. default_cache_dir() is build/ of a writable checkout, else
    $XDG_CACHE_HOME/raytracer2_tpu_torch."""
    from raytracer2_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(tnative, "BUILD_DIR", tnative.BUILD_DIR)
    assert compile_cache.enable_compile_cache(tmp_path / "cache")
    assert _build.BUILD_DIR == tmp_path / "cache" / "kernels"
    lib = tnative._build()
    assert lib is not None and lib.parent == tmp_path / "cache" / "native"
    assert lib.name.startswith("libraytracer2_native_") and lib.exists()

    root = compile_cache.default_cache_dir()
    assert root.name == "build" and (root.parent
                                     / "raytracer2_tpu_torch").is_dir()
    monkeypatch.setattr(compile_cache.os, "access", lambda *a: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert compile_cache.default_cache_dir() == (tmp_path / "xdg"
                                                 / "raytracer2_tpu_torch")


@pytest.mark.parametrize("method", ["sah", "morton", "auto"])
def test_build_clusters_method_matches_jax(tiny, method):
    """build_clusters(method=) against JAX's, every array bit for bit; the
    two methods build different clusters."""
    from raytracer2_tpu.ops import cluster as jcluster

    s = tiny["scene"]
    v0, e1, e2 = s.host_tri_v0, s.host_tri_edge1, s.host_tri_edge2
    want = jcluster.build_clusters(v0, e1, e2, cluster_size=4, method=method)
    got = tcluster.build_clusters(v0, e1, e2, 4, method, device=CPU)
    for f in jcluster.Clusters._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    if method == "morton":
        sah = tcluster.build_clusters(v0, e1, e2, 4, "sah", device=CPU)
        assert not torch.equal(sah.tri_index, got.tri_index)


def test_build_clusters_sah_raises_without_the_native_builder(tiny,
                                                              monkeypatch):
    monkeypatch.setattr(tnative, "build_sah_clusters", lambda *a: None)
    s = tiny["scene"]
    with pytest.raises(RuntimeError, match="SAH"):
        tcluster.build_clusters(s.host_tri_v0, s.host_tri_edge1,
                                s.host_tri_edge2, 4, "sah", device=CPU)
    with pytest.raises(ValueError):
        tcluster.build_clusters(s.host_tri_v0, s.host_tri_edge1,
                                s.host_tri_edge2, 4, "bvh", device=CPU)


def test_onion_outer_radius_matches_jax():
    from raytracer2_tpu.restir import regir as jregir
    from raytracer2_tpu_torch.restir import regir as tregir

    for cell in (0.5, 2.0):
        want = jregir.build_onion_layout(cell).outer_radius
        got = tregir.build_onion_layout(cell).outer_radius
        assert got == want and len(got) == 2


def test_knob_instances_and_their_counts():
    """Each knob set names its kernel instance; the default is ""."""
    assert ct.knob_instance() == ""
    assert ct.knob_instance(depth=4, mb=1) == ""
    assert ct.knob_instance(depth=1, mb=2, lean=True, debug_steps=True,
                            mm=True) == "depth=1,mb=2,lean,steps,mm"
    with pytest.raises(ValueError):
        ct.knob_instance(depth=5)
    with pytest.raises(ValueError):
        ct.knob_instance(mb=0)


# ---------------------------------------------------------------------------
# The kernel instances against their plain versions, on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card(dev, tmp_path_factory):
    _, scene, _, clusters, tables = _scene(tmp_path_factory, dev)
    o, d, tn, tx = (torch.from_numpy(x).to(dev) for x in _rays())
    smin, smax = clusters.aabb_min.amin(dim=0), clusters.aabb_max.amax(dim=0)
    closest = ct.prepare_bundles_exact(clusters, o, d, tn, tx, smin, smax, P,
                                       False, K_CAND)
    vis = ct.prepare_bundles_exact(clusters, o, d, tn,
                                   torch.where(tx > 0, SHORT, tx), smin,
                                   smax, P, False, K_CAND)
    sc = ct._prepare(clusters, o, d, tn, tx, smin, smax, P, False, "sc",
                     K_CAND, m_super=8)

    def args(prep):
        return (ct._rays8(prep), prep.cand_idx, prep.cand_t,
                prep.cand_count, tables.wald_rows)

    return dict(clusters=clusters, tables=tables, rays=(o, d, tn, tx),
                closest=args(closest), vis=args(vis), sc=args(sc))


KNOBS_CLOSEST = [dict(lean=True), dict(debug_steps=True), dict(depth=1),
                 dict(depth=2), dict(depth=3), dict(depth=4), dict(mb=2),
                 dict(mb=3, depth=1, lean=True, debug_steps=True)]
KNOBS_OCCLUDED = [dict(debug_steps=True), dict(depth=1), dict(depth=2),
                  dict(depth=3), dict(mb=2),
                  dict(mb=3, depth=1, debug_steps=True)]


def _as_rows(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", KNOBS_CLOSEST)
def test_closest_kernel_instances_match_plain_on_card(card, knobs):
    """B1's instances (lean, debug_steps, depth 1-4, mb) against the plain
    version with the same outputs, every row bit for bit, each launch
    counted under its instance."""
    lanes = card["tables"].lanes
    inst = ct.knob_instance(**knobs)
    before = (ct.walk_closest.launches if not inst
              else ct.walk_closest.knob_launches.get(inst, 0))
    got = _as_rows(ct.walk_closest(*card["closest"], group=GROUP, lanes=lanes,
                                   **knobs))
    torch.cuda.synchronize()
    after = (ct.walk_closest.launches if not inst
             else ct.walk_closest.knob_launches[inst])
    assert after == before + 1
    plain = {k: v for k, v in knobs.items() if k in ("lean", "debug_steps")}
    want = _as_rows(ct.walk_closest_reference(*card["closest"], group=GROUP,
                                              **plain))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    default = ct.walk_closest(*card["closest"], group=GROUP, lanes=lanes)
    code = want[0] if not knobs.get("lean") else None
    if code is not None:
        np.testing.assert_array_equal(code.cpu().numpy(),
                                      default.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", KNOBS_OCCLUDED)
def test_occluded_kernel_instances_match_plain_on_card(card, knobs):
    lanes = card["tables"].lanes
    got = _as_rows(ct.walk_occluded(*card["vis"], group=GROUP, lanes=lanes,
                                    **knobs))
    want = _as_rows(ct.walk_occluded_reference(
        *card["vis"], group=GROUP, debug_steps=knobs.get("debug_steps", False)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert 0 < int(want[0].sum()) < N


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["closest", "occluded"])
@pytest.mark.parametrize("knobs", [dict(depth=1), dict(depth=2, mb=2),
                                   dict(debug_steps=True, depth=3)])
def test_sc_kernel_instances_match_plain_on_card(card, walk, knobs):
    args = card["sc"]
    got = _as_rows(getattr(ct, f"walk_{walk}_sc")(
        *args, group=8, lanes=card["tables"].lanes, **knobs))
    want = _as_rows(getattr(ct, f"walk_{walk}_reference")(
        *args, group=8, sc_m=8, debug_steps=knobs.get("debug_steps", False)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["closest", "occluded"])
def test_mm_kernels_match_plain_mm_on_card(card, walk):
    """The tensor-core form against hit_test_mm's walk: on this scene no
    ray lies within the products' rounding of an edge, so outputs and
    steps are equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = card["closest" if walk == "closest" else "vis"]
    got = getattr(ct, f"walk_{walk}")(*args, group=GROUP,
                                      lanes=card["tables"].lanes, mm=True,
                                      debug_steps=True)
    want = getattr(ct, f"walk_{walk}_reference")(*args, group=GROUP, mm=True,
                                                 debug_steps=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def _cap_rays(dev, c=300, n=4096, seed=5):
    """Random boxes and rays with dead, padded, NaN and box-face rays."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-5, 5, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 2.0, (c, 3)).astype(np.float32)
    lo[7], hi[7] = hi[7].copy(), lo[7].copy()  # an inverted (empty) box
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-3, np.float32)
    tx = np.where(rng.uniform(size=n) < 0.5, 1e5,
                  rng.uniform(0.5, 8, n)).astype(np.float32)
    i = np.arange(n)
    tx[i % 29 == 8] = -1.0
    o[i % 41 == 11, 0] = np.nan
    d[i % 43 == 12, 1] = np.inf
    face = i % 19 == 7  # the far face of box 3 at the origin: far = +-0
    o[face] = hi[3]
    d[face] = [1.0, 0.0, 0.0]
    tn[face] = 0.0
    rays8 = np.concatenate([o, d, tn[:, None], tx[:, None]], axis=1)
    return (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (rays8, lo, hi))


def test_union_cap_plain_matches_entry_exact_cap():
    """The plain cap is the max over overlapped boxes of far, -inf where
    none, with every zero +0, and the union is bundle_union's."""
    rays8, lo, hi = _cap_rays(CPU)
    union, cap = cull.bundle_union(rays8, lo, hi, P, cap=True)
    np.testing.assert_array_equal(
        union.numpy().view(np.int32),
        cull.bundle_union(rays8, lo, hi, P).numpy().view(np.int32))
    near, far, hit = cull._slab(rays8[:, 0:3], rays8[:, 3:6], rays8[:, 6],
                                rays8[:, 7], lo, hi)
    want = torch.where(hit, far, -torch.inf).amax(dim=1)
    np.testing.assert_array_equal(cap.numpy(), want.numpy())
    assert not torch.signbit(cap[cap == 0.0]).any()
    assert torch.isneginf(cap).any() and torch.isfinite(cap).any()


@pytest.mark.cuda
@pytest.mark.parametrize("c,p", [(300, 32), (1500, 128), (3072, 256)])
def test_union_cap_kernel_matches_plain_on_card(dev, c, p):
    """B4's cap instance against bundle_union_reference(cap=True): the
    union table and each ray's cap bit for bit (the cap's max crosses the
    blocks of a bundle's box tiles), counted as the "cap" instance."""
    rays8, lo, hi = _cap_rays(dev, c=c, n=4096 // p * p)
    before = cull.bundle_union.knob_launches.get("cap", 0)
    got = cull.bundle_union(rays8, lo, hi, p, cap=True)
    torch.cuda.synchronize()
    assert cull.bundle_union.knob_launches["cap"] == before + 1
    want = cull.bundle_union_reference(rays8, lo, hi, p, cap=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                      w.cpu().numpy().view(np.int32))
