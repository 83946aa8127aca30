"""The k_cand auto-sizing probe of the PyTorch port against the JAX
package: cuda_traverse.union_max_bundle (the largest per-bundle candidate
union of a batch) for the exact and interval culls, the tracers'
union_max, suggest_k_cand and make_tracers(k_cand_per_class=), and
utils/readback.py::guarded_scalar.

The scene is a small procedural corridor (the ladder's pattern cut to 4
segments), cut into clusters of 16 triangles so bundles see many clusters;
the JAX functions run over the port's clusters. Union counts and the
suggested budgets are compared exactly.
"""

import dataclasses
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as jproc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.render import app_bridge as jab
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.render import app_bridge as tab
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.render import rays as traysmod
from raytracer2_tpu_torch.scene.camera import default_camera as t_camera
from raytracer2_tpu_torch.utils.readback import guarded_scalar

W, H = 64, 32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    p = tmp_path_factory.mktemp("kc") / "corridor.glb"
    jproc.write_glb(p, jproc.corridor_glb(segments=4, pillars_per_side=4,
                                          lat=12, lon=16))
    j_scene = j_build_scene(gltf.load_file(p))
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    mp = pytest.MonkeyPatch()
    mp.setattr(tab, "CLUSTER_SIZE", 16)
    try:
        renderer = tframe.create_renderer(t_scene, W, H, presample=False)
    finally:
        mp.undo()
    tr = renderer.tracers
    jc = jcluster.Clusters(*(jnp.asarray(x.numpy()) for x in tr.clusters))
    cam = dict(window_size=(W, H), position=(0.3, 1.1, 15),
               direction=(0, 0, 1))
    return dict(j_scene=j_scene, renderer=renderer, jc=jc,
                smin=jnp.asarray(tr.scene_min.numpy()),
                smax=jnp.asarray(tr.scene_max.numpy()),
                view=default_camera(**cam).planar_view_constants(),
                t_view=t_camera(**cam).planar_view_constants())


def _incoherent(corridor, n=4096, seed=80):
    s = corridor["j_scene"]
    lo, hi = s.host_tri_v0.min(axis=0), s.host_tri_v0.max(axis=0)
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    return (o, d, np.full(n, 1e-3, np.float32), np.full(n, 1e5, np.float32))


def _primaries(corridor):
    """The camera's primary rays in 8x16 screen-tile order."""
    view = corridor["t_view"]
    px, py = traysmod.pixel_grid(W, H, device=CPU)
    pr = traysmod.setup_primary_ray(px.reshape(-1), py.reshape(-1), view)
    th, tw = traysmod.tile_shape(W, H)
    idx = torch.from_numpy(traysmod.tile_permutation(W, H, tw, th)).long()
    return tuple(x.numpy() for x in (pr.origin[idx], pr.direction[idx],
                                     pr.t_min, pr.t_max))


@pytest.mark.parametrize("case", ["exact", "exact_presorted", "interval"])
def test_union_max_bundle_matches_jax(corridor, case):
    """The largest per-bundle union, exactly JAX's: the exact cull on
    incoherent rays (cand0-sorted) and on presorted ones, the interval
    cull on presorted primary tiles."""
    rays = _primaries(corridor) if case == "interval" else \
        _incoherent(corridor)
    cull = "interval" if case == "interval" else "exact"
    presorted = case != "exact"
    clusters = corridor["renderer"].tracers.clusters
    tr = corridor["renderer"].tracers
    got = ct.union_max_bundle(clusters, *map(torch.from_numpy, rays),
                              tr.scene_min, tr.scene_max, bundle_size=128,
                              cull=cull, presorted=presorted)
    want = ptm.union_max_bundle(corridor["jc"], *map(jnp.asarray, rays),
                                corridor["smin"], corridor["smax"],
                                bundle_size=128, cull=cull,
                                presorted=presorted)
    assert got.dim() == 0 and got.dtype == torch.int32
    assert int(got) == int(want)
    assert 1 < int(got) < clusters.num_clusters


def _j_renderer(corridor):
    """A JAX-side renderer for suggest_k_cand: JAX's union_max_bundle over
    the port's clusters with the port's per-class shapes."""
    tr = corridor["renderer"].tracers
    shapes = tr.shapes_by_class

    def umax(o, d, tmin, tmax, presorted=False):
        cfg = shapes[presorted]
        return ptm.union_max_bundle(
            corridor["jc"], o, d, tmin, tmax, corridor["smin"],
            corridor["smax"], bundle_size=cfg["bundle_size"],
            cull=cfg["cull"], presorted=bool(presorted))

    tracers = jab.Tracers(closest_hit=None, occluded=None, union_max=umax,
                          k_cand_by_class=tr.k_cand_by_class)
    return types.SimpleNamespace(tracers=tracers,
                                 scene=corridor["j_scene"], width=W,
                                 height=H)


@pytest.mark.parametrize("with_view", [True, False])
def test_suggest_k_cand_matches_jax(corridor, with_view, monkeypatch):
    """suggest_k_cand returns JAX's dict (small quantum and floor, so the
    probe's maxima show through), and None where the budgets already
    match."""
    view = corridor["view"] if with_view else None
    kw = dict(quantum=8, k_floor=8, n_incoherent=8192)
    want = jab.suggest_k_cand(_j_renderer(corridor), view, **kw)
    t_view = corridor["t_view"] if with_view else None
    got = tab.suggest_k_cand(corridor["renderer"], t_view, **kw)
    assert got == want and got is not None
    assert set(got) == ({True, False, "shadow"} if with_view
                        else {False, "shadow"})
    monkeypatch.setattr(tab, "CLUSTER_SIZE", 16)
    renderer = dataclasses.replace(
        corridor["renderer"], tracers=tab.make_tracers(
            corridor["renderer"].scene, k_cand_per_class=got))
    assert tab.suggest_k_cand(renderer, t_view, **kw) is None


def test_k_cand_per_class_keeps_the_hits(corridor, monkeypatch):
    """make_tracers(k_cand_per_class=) sets each class's budget; a budget
    below the unions sends bundles to the fallback, which keeps every hit."""
    base = corridor["renderer"].tracers
    scene = corridor["renderer"].scene
    monkeypatch.setattr(tab, "CLUSTER_SIZE", 16)
    small = tab.make_tracers(scene, k_cand_per_class={False: 2, True: None})
    assert small.k_cand_by_class == {**base.k_cand_by_class, False: 2}
    rays = [torch.from_numpy(x) for x in _incoherent(corridor, 1024)]
    want = base.closest_hit(*rays)
    got = small.closest_hit(*rays)
    assert small.fallback_by_class.get(False, 0) > 0
    for f in want._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0)


def test_backends_without_a_probe(corridor):
    """The pair sweep and brute force have no union_max (as in the JAX
    package, whose pairs tracers have none): suggest_k_cand returns
    None."""
    scene = corridor["renderer"].scene
    for backend in ("pairs", "brute"):
        tr = tab.make_tracers(scene, backend=backend)
        assert tr.union_max is None
        renderer = dataclasses.replace(corridor["renderer"], tracers=tr)
        assert tab.suggest_k_cand(renderer, None) is None


# ---------------------------------------------------------------------------
# guarded_scalar
# ---------------------------------------------------------------------------

def test_guarded_scalar_reads_the_value():
    got = guarded_scalar(torch.tensor([3, 141], dtype=torch.int32))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, [3, 141])


class _Stalled:
    """Stands in for a tensor whose read never finishes (until released)."""

    def __init__(self):
        self.release = threading.Event()

    def detach(self):
        return self

    def cpu(self):
        self.release.wait(30)
        return torch.zeros(1)


def test_guarded_scalar_returns_default_on_a_stall():
    x = _Stalled()
    try:
        assert guarded_scalar(x, timeout=0.2, default="none") == "none"
    finally:
        x.release.set()


class _Faulting:
    def detach(self):
        raise RuntimeError("CUDA error: an illegal memory access")


def test_guarded_scalar_raises_the_read_error():
    """A read that fails (a CUDA fault) raises in the caller, unlike the
    JAX package's, which returns the default."""
    with pytest.raises(RuntimeError, match="illegal memory access"):
        guarded_scalar(_Faulting(), timeout=5.0, default=0)
