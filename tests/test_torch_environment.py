"""The environment slice of the PyTorch port against the JAX package: the
EXR reader and writer with the PIZ codec (scene/exr.py, scene/piz.py, the
port's own copies), the procedural sky, the environment's RIS-tile
presample (lights/prepare.py::presample_environment_map), the renderer's
RIS buffer under a skybox, and ReSTIR frames lit by the sky.

Files written by one package are read by the other bit for bit, and each
package's writer gives the same bytes. The presample and the RIS buffer
are bit-exact. The frames render the Cornell box at 16x16 from a camera
off the box's axis under a procedural sky with environment=1 (the sky
lights the background and the escaped bounces), once more with one
environment-map candidate per pixel; both packages trace through the same
clusters (JAX's Pallas walks in interpret mode, the port's plain walks)
and display, diffuse and specular agree within rtol=atol=2e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.lights import prepare as jprep
from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render.app_bridge import Tracers as JTracers
from raytracer2_tpu.scene import exr as jexr
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.lights import prepare as tprep
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.scene import exr as texr

W = H = 16
CPU = torch.device("cpu")
SKY_HEIGHT = 32  # a 64x32 equirect sky

# (rows, columns, compression, dtype): single- and multi-block files (PIZ
# packs 32 scanlines a block) and an odd width
EXR_CASES = [
    (9, 14, "none", "float16"),
    (9, 14, "none", "float32"),
    (9, 14, "piz", "float16"),
    (9, 14, "piz", "float32"),
    (70, 24, "piz", "float16"),
    (12, 17, "piz", "float32"),
]
PACKAGES = {"jax": jexr, "torch": texr}


def _hdr_image(rows, cols, seed):
    """An HDR image with exact zeros and a bright sun-like spot."""
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(scale=2.0, size=(rows, cols, 3))).astype(
        np.float32)
    img[0, :3] = 0.0
    img[rows // 2, cols // 2] = [5e3, 4e3, 6e4]
    return img


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("rows,cols,compression,dtype", EXR_CASES,
                         ids=[f"{r}x{c}-{k}-{d}" for r, c, k, d in EXR_CASES])
def test_exr_files_cross_between_packages(tmp_path, writer, rows, cols,
                                          compression, dtype):
    """A file one package writes, the other reads bit for bit as the
    writer itself reads it; both writers give the same bytes."""
    img = _hdr_image(rows, cols, rows * cols)
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = tmp_path / f"{name}.exr"
        mod.write_exr(paths[name], img, compression=compression,
                      dtype=dtype)
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    reader = "torch" if writer == "jax" else "jax"
    got = PACKAGES[reader].load_exr(paths[writer])
    want = PACKAGES[writer].load_exr(paths[writer])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (rows, cols, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got, img.astype(dtype).astype(np.float32))


def test_procedural_sky_matches_jax():
    for height in (16, 48):
        got = texr.procedural_sky(height=height)
        want = jexr.procedural_sky(height=height)
        assert got.shape == (height, 2 * height, 3)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.fixture(scope="module")
def sky_scene(tmp_path_factory):
    """The Cornell box under a 64x32 procedural sky, written through the
    JAX package's PIZ writer and read back by the port: JAX's scene and
    the port's, carried across."""
    d = tmp_path_factory.mktemp("env")
    jexr.write_exr(d / "sky.exr", jexr.procedural_sky(height=SKY_HEIGHT),
                   compression="piz", dtype="float16")
    sky = texr.load_exr(d / "sky.exr")
    proc.write_glb(d / "cornell.glb", proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(d / "cornell.glb"), skybox=sky)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    return j_scene, t_scene


@pytest.mark.parametrize("seed", [0, 5])
def test_presample_environment_map_bit_exact(sky_scene, seed):
    """On the same environment pdf (JAX's, carried across) and on the
    port's own, every RIS word bit for bit."""
    j_scene, t_scene = sky_scene
    j_lights = jprep.prepare_lights(j_scene)
    tiles = dict(tile_count=16, tile_size=512)
    want = np.asarray(jax.jit(functools.partial(
        jprep.presample_environment_map, **tiles), static_argnums=0)(
        seed, j_lights)).astype(np.int64)
    carried = convert.scene_lights_from_numpy(convert.to_numpy_tree(j_lights),
                                              device=CPU)
    for lights in (carried, tprep.prepare_lights(t_scene)):
        got = tprep.presample_environment_map(seed, lights, **tiles)
        assert got.shape == (16 * 512, 2) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # every slot holds a texel of positive pdf; the uv words spread
    assert (got[:, 1] > 0).all()
    assert len(np.unique(want[:, 0])) > 1000


def test_presample_environment_map_needs_a_sky(sky_scene):
    _, t_scene = sky_scene
    lights = tprep.prepare_lights(t_scene)._replace(env_pdf_mips=None)
    with pytest.raises(ValueError, match="skybox"):
        tprep.presample_environment_map(0, lights)


# JAX's Pallas walk seeds each ray's key with bits(t_max), so above its
# miss sentinel (the bits of ~1.7e38) a ray that meets a candidate cluster
# but no triangle comes back as a hit on a slot of it. The BRDF candidates
# pass t_max = FLT_MAX (brdf_cutoff 0): under a sky, where an escaped
# candidate samples the environment, JAX's would hit. The port's walk
# reports the miss. JAX's walk gets t_max clamped below the sentinel here,
# and its misses carry the caller's t_max.
T_MAX_BELOW_MISS_KEY = 1e38


def _j_pallas_tracers(port_tracers, j_scene) -> JTracers:
    """JAX's Pallas walks (interpret mode) over the port's clusters, with
    the port's per-class shapes."""
    c = port_tracers.clusters
    jc = jcluster.Clusters(*(jnp.asarray(x.numpy()) for x in c))
    smin = jnp.asarray(port_tracers.scene_min.numpy())
    smax = jnp.asarray(port_tracers.scene_max.numpy())
    shapes = port_tracers.shapes_by_class

    def closest(o, d, tmin, tmax, presorted=False):
        rec = ptm.closest_hit_bundle_pallas(
            jc, j_scene.tri_geometry, j_scene.tri_primitive, o, d, tmin,
            jnp.minimum(tmax, T_MAX_BELOW_MISS_KEY), smin, smax,
            interpret=True, mb=1, presorted=bool(presorted),
            **shapes[bool(presorted)])
        missed = rec.triangle_index < 0
        return rec._replace(t=jnp.where(
            missed, jnp.broadcast_to(tmax, missed.shape), rec.t))

    def occluded(o, d, tmin, tmax, presorted=False):
        cls = presorted if presorted == "shadow" else bool(presorted)
        return ptm.occluded_bundle_pallas(
            jc, o, d, tmin, tmax, smin, smax, interpret=True, mb=1,
            presorted=bool(presorted), **shapes[cls])

    return JTracers(closest_hit=closest, occluded=occluded)


@pytest.fixture(scope="module")
def renderers(sky_scene):
    j_scene, t_scene = sky_scene
    t_renderer = tframe.create_renderer(t_scene, W, H)
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    return j_renderer, t_renderer


def test_create_renderer_ris_buffer_matches_jax(renderers):
    """Local tiles then environment tiles, every word bit for bit."""
    j_renderer, t_renderer = renderers
    want = np.asarray(j_renderer.ris_buffer).astype(np.int64)
    got = t_renderer.ris_buffer
    assert got.shape == want.shape == (2 * 128 * 1024, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    env = got[128 * 1024:]
    assert (env[:, 1] > 0).all()  # the environment tiles are filled


# the frames: environment=1 in the flagship config (bench.py:266-272),
# then with one environment-map candidate per pixel
FRAME_CONFIGS = ("sky", "env_candidates")


def _gconst(j_scene, name):
    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    g = default_gconst(cam.planar_view_constants(),
                       j_scene.num_emissive_triangles, enable_restir_di=1,
                       environment=1)
    if name == "env_candidates":
        di = g.restir_di
        g = g.replace(restir_di=dataclasses.replace(
            di, initial_sampling_params=dataclasses.replace(
                di.initial_sampling_params,
                num_primary_environment_samples=1)))
    return g


@pytest.fixture(scope="module")
def sky_frames(sky_scene, renderers):
    """One frame of each configuration in both packages from a fresh
    state: {config: (JAX state, JAX display, port state, port display)}."""
    j_scene, _ = sky_scene
    j_renderer, t_renderer = renderers
    j_renderer = j_renderer._replace(
        tracers=_j_pallas_tracers(t_renderer.tracers, j_scene))
    out = {}
    for name in FRAME_CONFIGS:
        g = _gconst(j_scene, name)
        j_state, j_img = jframe.render_frame(j_renderer, g,
                                             jframe.init_frame_state(W, H))
        t_state, t_img = tframe.render_frame(
            t_renderer, convert.gconst_from_numpy(convert.to_numpy_tree(g)),
            tframe.init_frame_state(W, H, device=CPU))
        out[name] = (j_state, j_img, t_state, t_img)
    return out


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and (got >= 0).all(), name
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("config", FRAME_CONFIGS)
def test_sky_frame_matches_jax(sky_scene, renderers, sky_frames, config):
    j_state, j_img, t_state, t_img = sky_frames[config]
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05  # lit, not black
    # the sky lights the box through its open side: without it (the
    # environment off) the frame is darker
    g = _gconst(sky_scene[0], config).replace(environment=0)
    dark, _ = tframe.render_frame(
        renderers[1], convert.gconst_from_numpy(convert.to_numpy_tree(g)),
        tframe.init_frame_state(W, H, device=CPU))
    assert (float(t_state.diffuse_lighting.sum())
            > 1.01 * float(dark.diffuse_lighting.sum()))


def test_environment_candidates_change_the_frame(sky_frames):
    """The environment-map candidate takes samples from the environment
    RIS tiles: the DI lighting differs from the frame without it."""
    _, _, sky, _ = sky_frames["sky"]
    _, _, env, _ = sky_frames["env_candidates"]
    assert not torch.equal(sky.diffuse_lighting, env.diffuse_lighting)
