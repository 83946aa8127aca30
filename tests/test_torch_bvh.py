"""The lbvh backend of the PyTorch port (ops/bvh.py, ops/traverse.py,
make_tracers(backend="lbvh")) against the JAX package.

The build is bit-equal to JAX's (left, right, boxes, tri_order, Morton
codes, depth) on the test sphere, on the duplicate-position case of
tests/test_bvh.py and on the Cornell box. The walks give JAX's triangle,
geometry and primitive on every ray except t-ties (two triangles within
TIE_REL in t, counted and bounded); t, u and v agree within the
brute-force Möller-Trumbore's 1e-6 (XLA fuses its float math on the CPU).
Blocked flags equal JAX's. The same rays hold against the port's
brute-force oracles, and batching or compaction changes no answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import bvh as jbvh
from raytracer2_tpu.ops import traverse as jtrav
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.scene import build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import bvh as tbvh
from raytracer2_tpu_torch.ops import traverse as ttrav
from raytracer2_tpu_torch.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu_torch.render import app_bridge

CPU = torch.device("cpu")
N_RAYS = 2048
T_MIN, T_MAX, T_SHADOW = 1e-3, 1e5, 6.0
TIE_REL = 1e-5  # a closest hit within this relative t of another ties
MAX_TIES = 4  # t-ties allowed among N_RAYS rays
BVH_FIELDS = ("left", "right", "aabb_min", "aabb_max", "tri_order")


def _duplicates():
    """Eight triangles with one centroid: every Morton code is equal
    (tests/test_bvh.py::test_duplicate_positions_ok)."""
    v0 = np.zeros((8, 3), np.float32)
    e1 = np.tile(np.float32([[1.0, 0, 0]]), (8, 1))
    e2 = np.tile(np.float32([[0, 1.0, 0]]), (8, 1))
    return v0, e1, e2


def _rays(lo, hi, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the triangles, JAX's BVH, its Morton codes, depth and
    validation, and (for the two scenes) both packages' scenes, rays and
    JAX's closest hits and blocked flags."""
    d = tmp_path_factory.mktemp("bvh")
    glbs = {"sphere": proc.sphere_grid_glb(n=2, lat=8, lon=10),
            "cornell": proc.cornell_box_glb(light_emission=2.0)}
    out = {}
    for name, glb in glbs.items():
        p = d / f"{name}.glb"
        proc.write_glb(p, glb)
        j_scene = build_scene(gltf.load_file(p))
        tris = tuple(np.asarray(x) for x in (
            j_scene.tri_v0, j_scene.tri_edge1, j_scene.tri_edge2))
        out[name] = dict(tris=tris, j_scene=j_scene,
                         t_scene=convert.scene_from_numpy(
                             convert.to_numpy_tree(j_scene), device=CPU))
    out["duplicates"] = dict(tris=_duplicates())
    for case in out.values():
        v0, e1, e2 = (jnp.asarray(x) for x in case["tris"])
        bvh = jbvh.build_lbvh(v0, e1, e2)
        tmin = jnp.minimum(jnp.minimum(v0, v0 + e1), v0 + e2)
        tmax = jnp.maximum(jnp.maximum(v0, v0 + e1), v0 + e2)
        c = 0.5 * (tmin + tmax)
        case.update(
            j_bvh=bvh, np_bvh=convert.to_numpy_tree(bvh),
            codes=np.asarray(jbvh.morton_codes_3d(c, c.min(0), c.max(0))),
            depth=jbvh.max_depth(bvh), valid=jbvh.validate_bvh(bvh))
        if "j_scene" not in case:
            continue
        js = case["j_scene"]
        lo, hi = case["tris"][0].min(0) - 1.0, case["tris"][0].max(0) + 1.0
        o, dr = _rays(lo, hi, seed=5)
        hit = jtrav.closest_hit(bvh, js.tri_v0, js.tri_edge1, js.tri_edge2,
                                js.tri_geometry, js.tri_primitive,
                                jnp.asarray(o), jnp.asarray(dr), T_MIN, T_MAX)
        blocked = jtrav.occluded(bvh, js.tri_v0, js.tri_edge1, js.tri_edge2,
                                 jnp.asarray(o), jnp.asarray(dr), T_MIN,
                                 T_SHADOW)
        case.update(rays=(o, dr),
                    j_hit=jax.tree_util.tree_map(np.asarray, hit),
                    j_blocked=np.asarray(blocked))
    return out


def _port_bvh(case):
    return tbvh.build_lbvh(*(_t(x) for x in case["tris"]))


@pytest.mark.parametrize("name", ["sphere", "duplicates", "cornell"])
def test_build_lbvh_bit_exact(runs, name):
    case = runs[name]
    got = _port_bvh(case)
    assert got.num_leaves == case["j_bvh"].num_leaves
    for f in BVH_FIELDS:
        want = case["np_bvh"][f]
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have.view(np.uint32) if
                                      have.dtype == np.float32 else have,
                                      want.view(np.uint32) if
                                      want.dtype == np.float32 else want,
                                      err_msg=f)
    v0, e1, e2 = (_t(x) for x in case["tris"])
    tmin = torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2)
    tmax = torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2)
    c = 0.5 * (tmin + tmax)
    codes = tbvh.morton_codes_3d(c, c.amin(0), c.amax(0))
    np.testing.assert_array_equal(codes.numpy(),
                                  case["codes"].astype(np.int64))
    assert tbvh.max_depth(got) == case["depth"]
    assert tbvh.validate_bvh(got) == case["valid"]


def test_bit_helpers_match_jax():
    """_clz32 is jax.lax.clz on uint32 (32 for 0); the fit count is JAX's
    34 + max(1, ceil(log2 n)) next to powers of two too; the Morton
    spread wraps as uint32 does."""
    rng = np.random.default_rng(3)
    x = np.concatenate([np.uint32([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000,
                                   0xFFFFFFFF]),
                        rng.integers(0, 2**32, 64, dtype=np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(jax.lax.clz(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(
        tbvh._clz32(torch.from_numpy(x.astype(np.int64))).numpy(), want)
    for n in (2, 3, 4, 5, 1023, 1024, 1025, 2**20 - 1, 2**20 + 1,
              2**24 + 1, 259692):
        assert tbvh._fit_iters(n) == 34 + max(1, int(jnp.ceil(jnp.log2(n))))
    cells = np.arange(1024, dtype=np.uint32)
    np.testing.assert_array_equal(
        tbvh._expand_bits_10(torch.from_numpy(cells.astype(np.int64)))
        .numpy(), np.asarray(jbvh._expand_bits_10(jnp.asarray(cells))))


def _port_hits(case, bvh, o, d, stats=None):
    ts = case["t_scene"]
    return ttrav.closest_hit(bvh, ts.tri_v0, ts.tri_edge1, ts.tri_edge2,
                             ts.tri_geometry, ts.tri_primitive, _t(o), _t(d),
                             T_MIN, T_MAX, stats=stats)


def _assert_same_hits(got, want_tri, want_t, want_missed):
    """Same triangle except t-ties (bounded); t within 1e-6 where the
    triangle is the same."""
    tri = got.triangle_index.numpy()
    differ = tri != want_tri
    tie = differ & (got.missed.numpy() == want_missed) & (
        np.abs(got.t.numpy() - want_t) <= TIE_REL * np.abs(want_t))
    assert not (differ & ~tie).any(), np.nonzero(differ & ~tie)
    assert tie.sum() <= MAX_TIES
    np.testing.assert_allclose(got.t.numpy()[~differ], want_t[~differ],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["sphere", "cornell"])
def test_closest_hit_matches_jax(runs, name):
    case = runs[name]
    o, d = case["rays"]
    jh = case["j_hit"]
    got = _port_hits(case, _port_bvh(case), o, d)
    assert int((~got.missed).sum()) > N_RAYS // 8
    _assert_same_hits(got, jh.triangle_index, jh.t,
                      jh.geometry_index == 0xFFFFFFFF)
    same = got.triangle_index.numpy() == jh.triangle_index
    for f in ("geometry_index", "primitive_id"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[same],
            getattr(jh, f).astype(np.int64)[same])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same],
                                   getattr(jh, f)[same], atol=1e-5)
    # JAX's miss convention: t = t_max, primitive 0, triangle -1
    missed = got.missed.numpy()
    assert (got.t.numpy()[missed] == np.float32(T_MAX)).all()
    assert (got.primitive_id.numpy()[missed] == 0).all()
    assert (got.triangle_index.numpy()[missed] == -1).all()


@pytest.mark.parametrize("name", ["sphere", "cornell"])
def test_occluded_matches_jax(runs, name):
    case = runs[name]
    o, d = case["rays"]
    ts = case["t_scene"]
    got = ttrav.occluded(_port_bvh(case), ts.tri_v0, ts.tri_edge1,
                         ts.tri_edge2, _t(o), _t(d), T_MIN, T_SHADOW)
    assert 0 < int(got.sum()) < N_RAYS
    np.testing.assert_array_equal(got.numpy(), case["j_blocked"])


@pytest.mark.parametrize("name", ["sphere", "cornell"])
def test_lbvh_tracers_match_brute_force(runs, name):
    """make_tracers(backend="lbvh") on the port's scene against the port's
    brute-force oracles on the same rays, and a JAX-built BVH carried in
    with convert.bvh_from_numpy gives the same answers."""
    case = runs[name]
    ts = case["t_scene"]
    o, d = (_t(x) for x in case["rays"])
    tracers = app_bridge.make_tracers(ts, backend="lbvh")
    got = tracers.closest_hit(o, d, T_MIN, T_MAX)
    ref = intersect_brute_force(o, d, ts.tri_v0, ts.tri_edge1, ts.tri_edge2,
                                ts.tri_geometry, ts.tri_primitive, T_MIN,
                                T_MAX)
    _assert_same_hits(got, ref.triangle_index.numpy(), ref.t.numpy(),
                      ref.missed.numpy())
    blocked = tracers.occluded(o, d, T_MIN, T_SHADOW, presorted="shadow")
    ref_blocked = occluded_brute_force(o, d, ts.tri_v0, ts.tri_edge1,
                                       ts.tri_edge2, T_MIN, T_SHADOW)
    assert int((blocked != ref_blocked).sum()) <= MAX_TIES
    stats = tracers.walk_stats
    assert stats.calls == 2
    assert stats.steps == ttrav.CHECK_EVERY * stats.host_checks

    carried = app_bridge.make_tracers(
        ts, backend="lbvh",
        bvh=convert.bvh_from_numpy(case["np_bvh"], device=CPU))
    for a, b in zip(carried.closest_hit(o, d, T_MIN, T_MAX), got):
        assert torch.equal(a, b)


def test_batching_changes_no_answer(runs):
    """Each half of the batch, reversed, and every ray alone (a sample)
    give the full batch's answers: compaction is per ray."""
    case = runs["cornell"]
    o, d = case["rays"]
    bvh = _port_bvh(case)
    stats = ttrav.WalkStats()
    full = _port_hits(case, bvh, o, d, stats)
    assert stats.calls == 1 and stats.host_checks >= 2
    half = N_RAYS // 2
    parts = [_port_hits(case, bvh, o[s][::-1].copy(), d[s][::-1].copy())
             for s in (slice(0, half), slice(half, None))]
    for f, a in zip(full._fields, full):
        b = torch.cat([torch.flip(getattr(p, f), [0]) for p in parts])
        assert torch.equal(a, b), f
    for i in range(0, N_RAYS, 97):
        one = _port_hits(case, bvh, o[i:i + 1], d[i:i + 1])
        for a, b in zip(one, full):
            assert torch.equal(a[0], b[i])


def test_make_tracers_checks_the_stack_depth(runs, monkeypatch):
    case = runs["sphere"]
    monkeypatch.setattr(ttrav, "STACK_SIZE", case["depth"] - 1)
    with pytest.raises(ValueError, match="exceeds the traversal stack"):
        app_bridge.make_tracers(case["t_scene"], backend="lbvh")
    monkeypatch.setattr(ttrav, "STACK_SIZE", case["depth"])
    assert app_bridge.make_tracers(case["t_scene"], backend="lbvh").bvh \
        is not None
