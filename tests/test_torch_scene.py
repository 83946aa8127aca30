"""Scene and acceleration structure of the PyTorch port against the JAX
package: the scene arrays and the clusters bit for bit (both are built by
the same numpy code and the shared native SAH builder), the walk's Wald and
meta tables bit for bit, and texture, equirect and hit-attribute fetches
within 1e-6."""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import native
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene import scene as jscene
from raytracer2_tpu.utils import brdf as jbrdf
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cluster as tcluster
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops import native as tnative
from raytracer2_tpu_torch.scene import scene as tscene

CPU = torch.device("cpu")

SCENES = {
    "cornell_textured": lambda: proc.cornell_box_glb(light_emission=2.0,
                                                     textured_floor=True),
    "spheres_textured": lambda: proc.sphere_grid_glb(n=2, lat=6, lon=8,
                                                     textured=True),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request, tmp_path_factory):
    p = tmp_path_factory.mktemp("scene") / f"{request.param}.glb"
    proc.write_glb(p, SCENES[request.param]())
    model = gltf.load_file(p)
    sky = np.random.default_rng(1).uniform(size=(8, 16, 3)).astype(np.float32)
    return (jscene.build_scene(model, skybox=sky),
            tscene.build_scene(model, skybox=sky, device=CPU))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_array(got, want, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    else:  # uint32 arrays are carried as int64 in the port
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def test_build_scene_bit_exact(scenes):
    j_scene, t_scene = scenes
    for name in jscene.Scene._fields:
        want, got = getattr(j_scene, name), getattr(t_scene, name)
        if name == "geometry":
            for f in jscene.GeometryTable._fields:
                _assert_same_array(getattr(got, f), getattr(want, f), f)
        elif want is None or isinstance(want, (bool, int)):
            assert got == want, name
        else:
            _assert_same_array(got, want, name)


def test_scene_from_numpy_matches_build_scene(scenes):
    j_scene, t_scene = scenes
    conv = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                    device=CPU)
    for name in tscene.Scene._fields:
        want, got = getattr(t_scene, name), getattr(conv, name)
        if name == "geometry":
            for f in tscene.GeometryTable._fields:
                _assert_same_array(getattr(got, f), getattr(want, f), f)
        elif want is None or isinstance(want, (bool, int)):
            assert got == want, name
        else:
            _assert_same_array(got, want, name)


def _jax_native_loaded() -> bool:
    """Whether the JAX package's native SAH builder is loaded. In a fresh
    checkout its loader runs `make` into the library's own path, and a
    worker that loads the library while another worker's `make` still
    writes it keeps that failure (`_tried`) for its whole process, building
    Morton clusters: then wait until the file stops changing, clear the
    cached failure and load once more."""
    if native.available() or not native._LIB_PATH.exists():
        return native.available()
    last, deadline = None, time.monotonic() + 120.0
    while time.monotonic() < deadline:
        st = native._LIB_PATH.stat()
        if (st.st_size, st.st_mtime_ns) == last:
            break
        last = (st.st_size, st.st_mtime_ns)
        time.sleep(1.0)
    native._tried = False
    return native.available()


@pytest.mark.parametrize("cluster_size", [4, 64, 128])
def test_build_clusters_and_walk_tables_bit_exact(scenes, cluster_size):
    j_scene, t_scene = scenes
    assert _jax_native_loaded(), "the JAX package's SAH builder did not load"
    want = jcluster.build_clusters(
        j_scene.host_tri_v0, j_scene.host_tri_edge1, j_scene.host_tri_edge2,
        cluster_size=cluster_size)
    got = tcluster.build_clusters(
        t_scene.host_tri_v0, t_scene.host_tri_edge1, t_scene.host_tri_edge2,
        cluster_size=cluster_size, device=CPU)
    # both packages built SAH clusters: Morton clusters of either would
    # make the comparison pass or fail for the wrong reason
    assert native.available() and tnative.available()
    for f in jcluster.Clusters._fields:
        _assert_same_array(getattr(got, f), getattr(want, f), f)
    conv = convert.clusters_from_numpy(convert.to_numpy_tree(want),
                                       device=CPU)
    for f in jcluster.Clusters._fields:
        _assert_same_array(getattr(conv, f), getattr(got, f), f)

    tables = ct.build_tables(got, t_scene.tri_geometry, t_scene.tri_primitive)
    _assert_same_array(tables.wald_rows, ptm._wald_rows(want), "wald_rows")
    _assert_same_array(tables.meta_rows,
                       ptm._tri_meta(want, j_scene.tri_geometry,
                                     j_scene.tri_primitive), "meta_rows")


def test_native_sah_builder_is_used():
    """The port calls the shared native builder, not a copy of it."""
    assert native.available()
    v0 = np.random.default_rng(2).normal(size=(300, 3)).astype(np.float32)
    e = np.full((300, 3), 0.1, np.float32)
    arrays = tcluster.cluster_arrays(v0, e, np.roll(e, 1, axis=1), 16)
    order, _, _ = native.build_sah_clusters(v0, e, np.roll(e, 1, axis=1), 16)
    tri = arrays["tri_index"].reshape(-1)
    np.testing.assert_array_equal(tri[tri >= 0], order)


@dataclasses.dataclass
class _Textures:
    textures: np.ndarray
    sizes: np.ndarray
    modes: np.ndarray
    quad: np.ndarray


def _random_textures():
    rng = np.random.default_rng(3)
    sizes = np.asarray([[5, 3], [8, 8], [2, 7]], np.int32)
    tex = np.zeros((3, 8, 8, 4), np.float32)
    quad = np.zeros((3, 8, 8, 16), np.float32)
    for i, (w, h) in enumerate(sizes):
        img = rng.uniform(size=(h, w, 4)).astype(np.float32)
        tex[i, :h, :w] = img
        yp = np.roll(img, -1, axis=0)
        quad[i, :h, :w] = np.concatenate(
            [img, np.roll(img, -1, axis=1), yp, np.roll(yp, -1, axis=1)],
            axis=-1)
    modes = np.asarray([[0, 1, 2], [1, 0, 1], [0, 2, 0]], np.int32)
    return _Textures(tex, sizes, modes, quad.reshape(-1, 16))


@pytest.mark.parametrize("sampler", ["default_quad", "default", "modes"])
def test_sample_texture_bilinear_matches_jax(sampler):
    t = _random_textures()
    rng = np.random.default_rng(4)
    n = 2048
    idx = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    modes = t.modes if sampler == "modes" else None
    quad = t.quad if sampler == "default_quad" else None
    want = jscene.sample_texture_bilinear(
        jnp.asarray(t.textures), jnp.asarray(t.sizes), jnp.asarray(idx),
        jnp.asarray(uv), modes=None if modes is None else jnp.asarray(modes),
        quad=None if quad is None else jnp.asarray(quad))
    got = tscene.sample_texture_bilinear(
        torch.from_numpy(t.textures), torch.from_numpy(t.sizes),
        torch.from_numpy(idx), torch.from_numpy(uv),
        modes=None if modes is None else torch.from_numpy(modes),
        quad=None if quad is None else torch.from_numpy(quad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_sample_equirect_and_environment_match_jax(scenes):
    j_scene, t_scene = scenes
    d = np.random.default_rng(5).normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = np.array(jbrdf.direction_to_equirect_uv(jnp.asarray(d)))
    np.testing.assert_allclose(
        tscene.sample_equirect(t_scene.skybox, torch.from_numpy(uv)).numpy(),
        np.asarray(jscene.sample_equirect(j_scene.skybox, jnp.asarray(uv))),
        rtol=0, atol=1e-6)
    for env in (0, 1):
        np.testing.assert_allclose(
            tscene.get_environment_radiance(t_scene, torch.from_numpy(d),
                                            env).numpy(),
            np.asarray(jscene.get_environment_radiance(
                j_scene, jnp.asarray(d), env)), rtol=0, atol=1e-6)


def test_get_geometry_from_hit_matches_jax(scenes):
    j_scene, t_scene = scenes
    rng = np.random.default_rng(6)
    n = 1024
    tri = rng.integers(0, j_scene.num_triangles, n).astype(np.int32)
    geo = np.asarray(j_scene.tri_geometry)[tri]
    prim = np.asarray(j_scene.tri_primitive)[tri]
    uv = rng.uniform(0.0, 0.5, (n, 2)).astype(np.float32)
    for by_triangle in (False, True):
        want = jscene.get_geometry_from_hit(
            j_scene, jnp.asarray(geo), jnp.asarray(prim), jnp.asarray(uv),
            triangle_index=jnp.asarray(tri) if by_triangle else None)
        got = tscene.get_geometry_from_hit(
            t_scene, torch.from_numpy(geo), torch.from_numpy(prim),
            torch.from_numpy(uv),
            triangle_index=torch.from_numpy(tri) if by_triangle else None)
        for f in jscene.SurfaceGeometry._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
