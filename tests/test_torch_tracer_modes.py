"""The bundle walk's tracer configurations in the PyTorch port against the
JAX package: every cull and sort key of the candidate prep
(ops/cuda_traverse.py::_prepare against JAX's jitted _prep, bit for bit),
the supercluster walks of cull="sc" (walk_closest_sc, walk_occluded_sc:
their plain versions against JAX's Pallas walks in interpret mode, bit for
bit), every other mode's hits against the default exact cull's, and the
knobs of make_tracers, create_renderer and the app.

The scene is a small ladder corridor (2,906 triangles) in 8-triangle SAH
clusters (530 of them) that the port builds and gives to both packages:
enough that "hier" with k_sc = 2 drops superclusters and k_cand = 8
overflows, so the fallback runs. The rays mix long bounces, short
visibility segments and dead lanes. The CUDA kernels are held to their
plain versions on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu import app as japp
from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.scene import build_scene
from raytracer2_tpu_torch import app
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cluster as tcluster
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops import native as tnative
from raytracer2_tpu_torch.render import app_bridge
from raytracer2_tpu_torch.render import frame as tframe

CPU = torch.device("cpu")
N = 256
P = 32
M_SC = 4  # superclusters of 4 clusters for "hier" and "sc"
K_SC = 2  # "hier" refines 2 superclusters a bundle: some bundles drop more
SC_WALK_M = 8  # the walks' supercluster size at S_pad 128, as on the card

# (cull, sort_key, presorted, k_cand): every cull, every key of the exact
# cull and the interval cull's unsorted orders
PREP_CASES = [
    ("auto", "cand0", False, 8),
    ("exact", "hier", False, 8),
    ("exact", "sc4", False, 8),
    ("exact", "octz", False, 8),
    ("exact", "cand2", False, 8),
    ("exact", "cand0", True, 600),
    ("exact_iv", "cand0", False, 8),
    ("interval", "cand0", False, 8),
    ("interval", "octz", False, 8),
    ("hier", "cand0", False, 40),
    ("hier", "cand0", True, 40),
    ("sc", "cand0", False, 8),
    ("sc", "cand0", True, 8),
]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads a test worker: the plain walks are many small ops,
    which the driver's parallel workers would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    p = tmp_path_factory.mktemp("modes") / "corridor.glb"
    proc.write_glb(p, proc.corridor_glb(segments=3, pillars_per_side=3,
                                        lat=8, lon=10))
    j_scene = build_scene(gltf.load_file(p))
    assert tnative.available(), "the native SAH cluster builder must load"
    arrays = tcluster.cluster_arrays(j_scene.host_tri_v0,
                                     j_scene.host_tri_edge1,
                                     j_scene.host_tri_edge2, cluster_size=8)
    jc = jcluster.Clusters(**{f: jnp.asarray(arrays[f])
                              for f in jcluster.Clusters._fields})
    tc = tcluster.clusters_from_arrays(arrays, device=CPU)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    lo = j_scene.host_tri_v0.min(0)
    hi = j_scene.host_tri_v0.max(0)
    rng = np.random.default_rng(3)
    o = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full(N, 1e-3, np.float32)
    tx = np.full(N, 1e5, np.float32)
    tx[::13] = -1.0  # dead lanes
    tx[1::3] = rng.uniform(0.5, 4.0, len(tx[1::3]))  # visibility segments
    return dict(j_scene=j_scene, jc=jc, tc=tc, t_scene=t_scene,
                tables=ct.build_tables(tc, t_scene.tri_geometry,
                                       t_scene.tri_primitive),
                rays=(o, d, tn, tx),
                smin=np.array(jnp.min(jc.aabb_min, 0)),
                smax=np.array(jnp.max(jc.aabb_max, 0)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _args(corridor):
    o, d, tn, tx = corridor["rays"]
    return o, d, tn, tx, corridor["smin"], corridor["smax"]


@pytest.mark.parametrize("cull,sort_key,presorted,k_cand", PREP_CASES)
def test_prepare_matches_jax_prep_bit_exact(corridor, cull, sort_key,
                                            presorted, k_cand):
    """_prepare's permutation, candidate lists, entry distances, counts
    and overflow flags against JAX's jitted _prep at the same cull, key,
    k_cand, m_super and k_sc. JAX pads its candidate rows and rounds its
    bundles up to whole cull chunks: those bundles are empty."""
    want = jax.jit(functools.partial(
        ptm._prep, bundle_size=P, presorted=presorted, cull=cull,
        k_cand=k_cand, m_super=M_SC, k_sc=K_SC, sort_key=sort_key))(
        corridor["jc"], *_j(*_args(corridor)))
    got = ct._prepare(corridor["tc"], *_t(*_args(corridor)), P, presorted,
                      cull, k_cand, sort_key, M_SC, K_SC)
    (perm, o, _, _, tx, cand_idx_flat, _, cand_t, cand_count, _, _, kp, _,
     overflowed) = want
    b, k = got.cand_idx.shape
    assert b == N // P
    if presorted:
        assert got.perm is None and perm is None
    else:
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(got.o.numpy(), np.asarray(o)[:N])
    np.testing.assert_array_equal(got.tx.numpy(), np.asarray(tx)[:N])
    np.testing.assert_array_equal(got.cand_idx.numpy(),
                                  np.asarray(cand_idx_flat)[:b, :k])
    np.testing.assert_array_equal(
        got.cand_t.numpy(), np.asarray(cand_t).reshape(-1, kp)[:b, :k])
    np.testing.assert_array_equal(got.cand_count.numpy(),
                                  np.asarray(cand_count)[:b])
    np.testing.assert_array_equal(got.overflowed.numpy(),
                                  np.asarray(overflowed)[:b])
    assert not np.asarray(cand_count)[b:].any()
    assert got.sc_m == (M_SC if cull == "sc" else 0)
    if k_cand == 8 or cull == "hier":  # the budgets bite
        assert got.overflowed.any() != (cull == "sc")


@pytest.fixture(scope="module")
def sc_walks(corridor):
    """JAX's Pallas walks with cull="sc" in interpret mode (the only two
    interpret-mode compiles here) and the port's, over the same clusters."""
    s = corridor["j_scene"]
    j_args = _j(*_args(corridor))
    kw = dict(bundle_size=P, interpret=True, cull="sc", m_super=SC_WALK_M,
              mb=1)
    want = ptm.closest_hit_bundle_pallas(corridor["jc"], s.tri_geometry,
                                         s.tri_primitive, *j_args, **kw)
    want_b = ptm.occluded_bundle_pallas(corridor["jc"], *j_args, **kw)
    t_args = _t(*_args(corridor))
    got, n_ovf = ct.closest_hit_bundle(corridor["tc"], corridor["tables"],
                                       *t_args, bundle_size=P, cull="sc",
                                       m_super=SC_WALK_M)
    got_b, n_ovf_b = ct.occluded_bundle(corridor["tc"], corridor["tables"],
                                        *t_args, bundle_size=P, cull="sc",
                                        m_super=SC_WALK_M)
    assert n_ovf == n_ovf_b == 0  # full-length lists never overflow
    return want, want_b, got, got_b


def test_sc_walks_match_pallas_sc_walks_bit_exact(sc_walks):
    """walk_closest_sc's and walk_occluded_sc's plain versions (through
    closest_hit_bundle and occluded_bundle with cull="sc") against JAX's
    Pallas walks' sc_m branch: winner decode (ids, t, u, v) and blocked
    flags bit for bit."""
    want, want_b, got, got_b = sc_walks
    for f in ("triangle_index", "geometry_index", "primitive_id", "t", "u",
              "v"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    hits = int((got.triangle_index >= 0).sum())
    assert N // 4 < hits < N and 0 < int(got_b.sum()) < N


@pytest.mark.parametrize("walk", ["closest", "occluded"])
@pytest.mark.parametrize("m", [3, SC_WALK_M])
def test_sc_walk_is_the_cluster_walk_over_members(corridor, walk, m):
    """The supercluster walk (what csrc's kSc kernels do) is the cluster
    walk with group = m over each supercluster's m members (those past C
    zero rows), the supercluster's entry distance before each group: on
    the "sc" prep's lists, cut to their 12 nearest superclusters, bit for
    bit (530 clusters: m = 3 and 8 leave the last supercluster short)."""
    tc, tables = corridor["tc"], corridor["tables"]
    prep = ct._prepare(tc, *_t(*_args(corridor)), P, False, "sc", 8, "cand0",
                       m, K_SC)
    k = 12
    args = (ct._rays8(prep), prep.cand_idx[:, :k].contiguous(),
            prep.cand_t[:, :k].contiguous(),
            torch.clamp_max(prep.cand_count, k))
    reference = getattr(ct, f"walk_{walk}_reference")
    want = getattr(ct, f"walk_{walk}_sc")(*args, tables.wald_rows, m,
                                         lanes=tables.lanes)
    nb = args[1].shape[0]
    members = (args[1].long()[:, :, None] * m + torch.arange(m)
               ).reshape(nb, k * m).to(torch.int32)
    c = tables.wald_rows.shape[0]
    wald = torch.nn.functional.pad(tables.wald_rows,
                                   (0, 0, 0, 0, 0, (-c) % m)).contiguous()
    got = reference(args[0], members, args[2].repeat_interleave(m, 1),
                    args[3] * m, wald, m)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want != (ct.MISS_CODE if walk == "closest" else 0)).any()


# every mode of the bundle walk, against the default exact cull: (cull,
# sort_key, presorted, k_cand)
MODES = [
    ("exact", "hier", False, 8), ("exact", "sc4", False, 8),
    ("exact", "octz", False, 8), ("exact", "cand2", False, 8),
    ("exact_iv", "cand0", False, 8), ("interval", "cand0", False, 8),
    ("interval", "octz", False, 8), ("interval", "cand0", True, 8),
    ("hier", "cand0", False, 40), ("hier", "cand0", True, 40),
    ("sc", "cand0", False, 8), ("auto", "cand0", True, 8),
]


@pytest.fixture(scope="module")
def default_hits(corridor):
    t_args = _t(*_args(corridor))
    rec, _ = ct.closest_hit_bundle(corridor["tc"], corridor["tables"],
                                   *t_args, bundle_size=P)
    blocked, _ = ct.occluded_bundle(corridor["tc"], corridor["tables"],
                                    *t_args, bundle_size=P)
    return rec, blocked


@pytest.mark.parametrize("cull,sort_key,presorted,k_cand", MODES)
def test_every_mode_hits_as_the_default(corridor, default_hits, cull,
                                        sort_key, presorted, k_cand):
    """Closest hit and any hit through each cull and key equal the default
    (exact cull, cand0 key) trace: misses and t bit for bit, the triangle
    the same except where two hits tie in t exactly, blocked flags equal;
    the overflowed bundles took the fallback (hier's dropped superclusters
    included)."""
    want, want_b = default_hits
    t_args = _t(*_args(corridor))
    kw = dict(bundle_size=P, cull=cull, sort_key=sort_key,
              presorted=presorted, k_cand=k_cand, m_super=M_SC, k_sc=K_SC)
    got, n_ovf = ct.closest_hit_bundle(corridor["tc"], corridor["tables"],
                                       *t_args, **kw)
    blocked, n_ovf_b = ct.occluded_bundle(corridor["tc"], corridor["tables"],
                                          *t_args, **kw)
    np.testing.assert_array_equal(got.t.numpy().view(np.int32),
                                  want.t.numpy().view(np.int32))
    np.testing.assert_array_equal(got.missed.numpy(), want.missed.numpy())
    same = (got.triangle_index == want.triangle_index).numpy()
    assert same.mean() > 0.99
    np.testing.assert_array_equal(blocked.numpy(), want_b.numpy())
    assert (n_ovf > 0) == (cull != "sc")


def test_hier_drops_superclusters_and_the_fallback_restores_them(corridor):
    """At k_sc = 2 some bundle overlaps more superclusters than it
    refines; without the fallback it misses hits, with it the hits are
    the exact cull's."""
    t_args = _t(*_args(corridor))
    prep = ct._prepare(corridor["tc"], *t_args, P, False, "hier", 10_000,
                       "cand0", M_SC, K_SC)
    assert prep.overflowed.any()  # sc_dropped: k_cand is no limit here
    kw = dict(bundle_size=P, cull="hier", k_cand=10_000, m_super=M_SC,
              k_sc=K_SC)
    bare, _ = ct.closest_hit_bundle(corridor["tc"], corridor["tables"],
                                    *t_args, overflow_fallback=False, **kw)
    fixed, n_ovf = ct.closest_hit_bundle(corridor["tc"], corridor["tables"],
                                         *t_args, **kw)
    exact, _ = ct.closest_hit_bundle(corridor["tc"], corridor["tables"],
                                     *t_args, bundle_size=P)
    assert n_ovf == int(prep.overflowed.sum())
    assert (bare.missed != exact.missed).any()
    np.testing.assert_array_equal(fixed.t.numpy(), exact.t.numpy())


# ---------------------------------------------------------------------------
# make_tracers, create_renderer, the app
# ---------------------------------------------------------------------------

class _Recorder:
    """Wraps ct._prepare and the walks: records each prep's (bundle size,
    presorted, cull, k_cand, sort_key, m_super, k_sc) and each walk's
    group."""

    def __init__(self, monkeypatch):
        self.preps, self.groups = [], []
        for name in ("walk_closest", "walk_occluded", "walk_closest_sc",
                     "walk_occluded_sc"):
            monkeypatch.setattr(ct, name, self._walk(getattr(ct, name)))
        inner = ct._prepare

        def prepare(clusters, o, d, tn, tx, smin, smax, p, presorted, cull,
                    k_cand, sort_key="cand0", m_super=ct.M_SUPER,
                    k_sc=ct.K_SC, **knobs):
            self.preps.append((p, presorted, cull, k_cand, sort_key, m_super,
                               k_sc))
            return inner(clusters, o, d, tn, tx, smin, smax, p, presorted,
                         cull, k_cand, sort_key, m_super, k_sc, **knobs)

        monkeypatch.setattr(ct, "_prepare", prepare)

    def _walk(self, inner):
        def walk(*args, lanes, **knobs):
            self.groups.append(args[5])
            return inner(*args, lanes=lanes, **knobs)
        return walk


    def first(self, fn, *args, **kwargs):
        """fn's result and the (prep, group) of its first walk, before any
        fallback re-trace."""
        n, g = len(self.preps), len(self.groups)
        out = fn(*args, **kwargs)
        return out, self.preps[n], self.groups[g]


def _trace_classes(rec, tracers, corridor):
    """The first (prep, group) of a bounce, a pixel-tile and a visibility
    trace."""
    o, d, tn, tx = _t(*corridor["rays"])
    return [rec.first(fn, o, d, tn, tx, presorted=cls)[1:]
            for fn, cls in ((tracers.closest_hit, False),
                            (tracers.closest_hit, True),
                            (tracers.occluded, "shadow"))]


@pytest.mark.parametrize("shadow_order", ["pixz", "octz", "cand0"])
def test_make_tracers_knobs_reach_the_prep(corridor, monkeypatch,
                                           shadow_order):
    """cluster_size, bundle_size, group, k_cand, cull and sort_key
    override every class's shape (then k_cand_per_class), and
    shadow_order decides the visibility class's order: pixz keeps the
    pixel Z-order, octz and cand0 re-sort by that key."""
    rec = _Recorder(monkeypatch)
    tracers = app_bridge.make_tracers(
        corridor["t_scene"], cluster_size=8, bundle_size=64, group=2,
        k_cand=48, cull="exact", sort_key="hier", shadow_order=shadow_order,
        k_cand_per_class={True: 96})
    assert tracers.clusters.cluster_size == 8
    (bounce, g0), (tiles, g1), (shadow, g2) = _trace_classes(rec, tracers,
                                                             corridor)
    assert bounce == (64, False, "exact", 48, "hier", ct.M_SUPER, ct.K_SC)
    assert tiles == (64, True, "exact", 96, "hier", ct.M_SUPER, ct.K_SC)
    want_shadow = {"pixz": (True, "hier"), "octz": (False, "octz"),
                   "cand0": (False, "cand0")}[shadow_order]
    assert (shadow[1], shadow[4]) == want_shadow
    assert (g0, g1, g2) == (2, 2, 2)


def test_make_tracers_sc_and_hier(corridor, monkeypatch):
    """cull="sc" walks superclusters (group forced to m after the slot
    clamp: 1024 // S_pad = 8 of JAX's default 32) and "hier" keeps
    m_super, k_sc at JAX's defaults; the traces are the default's."""
    o, d, tn, tx = _t(*corridor["rays"])
    want = app_bridge.make_tracers(corridor["t_scene"], cluster_size=8)
    want_hit = want.closest_hit(o, d, tn, tx)
    want_blocked = want.occluded(o, d, tn, tx, presorted="shadow")
    rec = _Recorder(monkeypatch)
    firsts = {}
    for cull in ("sc", "hier"):
        tracers = app_bridge.make_tracers(corridor["t_scene"],
                                          cluster_size=8, cull=cull)
        got, prep, group = rec.first(tracers.closest_hit, o, d, tn, tx)
        np.testing.assert_array_equal(got.t.numpy(), want_hit.t.numpy())
        blocked, shadow, _ = rec.first(tracers.occluded, o, d, tn, tx,
                                       presorted="shadow")
        np.testing.assert_array_equal(blocked.numpy(), want_blocked.numpy())
        firsts[cull] = prep, shadow, group
    prep, shadow, group = firsts["sc"]
    assert prep[2] == shadow[2] == "sc" and prep[5] == group == 8
    assert firsts["hier"][0][2:] == ("hier", 256, "cand0", 32, 12)


@pytest.mark.parametrize("backend", ["bundle", "scatter", "bundle_pallas"])
def test_make_tracers_engine_backends_trace(corridor, backend):
    """The JAX backends bundle, scatter and bundle_pallas (the port's
    bundle walk) build with JAX's cluster sizes and give the bundle walk's
    hits (no scatter pool overflows on these rays)."""
    o, d, tn, tx = _t(*corridor["rays"])
    want = app_bridge.make_tracers(corridor["t_scene"])
    tracers = app_bridge.make_tracers(corridor["t_scene"], backend=backend)
    size = {"bundle": 64, "scatter": 16, "bundle_pallas": 128}[backend]
    assert tracers.clusters.cluster_size == size
    got = tracers.closest_hit(o, d, tn, tx)
    np.testing.assert_array_equal(got.t.numpy(),
                                  want.closest_hit(o, d, tn, tx).t.numpy())
    np.testing.assert_array_equal(
        tracers.occluded(o, d, tn, tx, presorted="shadow").numpy(),
        want.occluded(o, d, tn, tx, presorted="shadow").numpy())
    assert not tracers.overflow_by_class.get(False)


def test_create_renderer_forwards_tracer_options(corridor):
    scene = corridor["t_scene"]
    r = tframe.create_renderer(scene, 8, 8, presample=False,
                               tracer_opts=dict(cluster_size=8, group=2,
                                                shadow_order="octz"),
                               k_cand_per_class={False: 64})
    shapes = r.tracers.shapes_by_class
    assert r.tracers.clusters.cluster_size == 8
    assert {c: s["group"] for c, s in shapes.items()} == {
        True: 2, False: 2, "shadow": 2}
    assert shapes["shadow"]["sort_key"] == "octz"
    assert shapes[False]["k_cand"] == 64
    brute = tframe.create_renderer(scene, 8, 8, use_bvh=False,
                                   presample=False)
    assert brute.tracers.clusters is None and brute.tracers.union_max is None


def test_app_flags_are_the_jax_apps():
    """The six traversal flags take the JAX app's choices, the backends
    include every JAX backend, and tracer_options builds the JAX app's
    tracer_opts (--k-cand goes to every class's budget instead)."""
    def actions(parser):
        return {a.dest: a for a in parser._actions}

    port, jax_app = actions(app.build_arg_parser()), actions(
        japp.build_arg_parser())
    for dest in ("cull", "group", "bundle_size", "shadow_order", "sort_key",
                 "cluster_size", "k_cand"):
        assert port[dest].choices == jax_app[dest].choices, dest
        assert port[dest].type == jax_app[dest].type, dest
    assert set(jax_app["backend"].choices) <= set(port["backend"].choices)
    args = app.build_arg_parser().parse_args(
        ["--cull", "hier", "--group", "2", "--bundle-size", "64",
         "--shadow-order", "octz", "--sort-key", "octz",
         "--cluster-size", "16", "--k-cand", "64"])
    assert app.tracer_options(args) == dict(
        cull="hier", group=2, bundle_size=64, sort_key="octz",
        shadow_order="octz", cluster_size=16)


@pytest.mark.parametrize("flags", [
    ["--backend", "bundle_pallas", "--cull", "hier", "--sort-key", "octz",
     "--shadow-order", "cand0", "--group", "2", "--bundle-size", "64",
     "--cluster-size", "16", "--k-cand", "64"],
    ["--backend", "bundle", "--cluster-size", "32"],
    ["--backend", "scatter"],
])
def test_app_renders_with_the_tracer_flags(tmp_path, monkeypatch, flags):
    """One 24x16 DI+GI frame of the Cornell box through the app with the
    traversal flags (and the visibility rays of DI's final shading):
    the tracers carry them, the PNG and metrics.json are written."""
    made = []
    inner = app_bridge.make_tracers

    def make(*args, **kwargs):
        made.append(kwargs)
        return inner(*args, **kwargs)

    monkeypatch.setattr(app_bridge, "make_tracers", make)
    monkeypatch.setattr(tframe, "make_tracers", make)
    out = tmp_path / "out"
    assert app.main(flags + ["--device", "cpu", "--width", "24",
                             "--height", "16", "--frames", "1",
                             "--out", str(out)]) == 0
    assert (out / "frame_0000.png").exists()
    assert (out / "metrics.json").exists()
    given = dict(zip(flags[::2], flags[1::2]))
    kw = made[0]
    assert kw["backend"] == given["--backend"]
    if "--cull" in given:
        assert (kw["cull"], kw["sort_key"], kw["shadow_order"], kw["group"],
                kw["bundle_size"], kw["cluster_size"]) == (
            "hier", "octz", "cand0", 2, 64, 16)
        assert kw["k_cand_per_class"] == {True: 64, False: 64, "shadow": 64}
    if "--cluster-size" in given:
        assert kw["cluster_size"] == int(given["--cluster-size"])
