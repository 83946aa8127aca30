"""The lights slice of the PyTorch port against the JAX package: the light
table (lights/prepare.py, lights/polymorphic.py), the pdf textures and
their sampling (lights/pdf_texture.py), light shaping (lights/shaping.py)
and the RIS-tile presample.

Scenes are the Cornell box (its ceiling quad is the light) and the same box
under a procedural sky, each built by the JAX package and carried across
with raytracer2_tpu_torch.convert; random inputs come from numpy with a
seed. The light records and the RIS tiles are bit-exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.lights import pdf_texture as jpdf
from raytracer2_tpu.lights import polymorphic as jpoly
from raytracer2_tpu.lights import prepare as jprep
from raytracer2_tpu.lights import shaping as jshape
from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.exr import procedural_sky
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu.utils import rng as jrng
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.lights import pdf_texture as tpdf
from raytracer2_tpu_torch.lights import polymorphic as tpoly
from raytracer2_tpu_torch.lights import prepare as tprep
from raytracer2_tpu_torch.lights import shaping as tshape
from raytracer2_tpu_torch.utils import rng as trng

CPU = torch.device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(got, want, name=""):
    """Equal values: float32 bit for bit, integers as uint32 words."""
    got, want = _np(got), _np(want)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                                      want.astype(np.int64) & 0xFFFFFFFF,
                                      err_msg=name)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    p = tmp_path_factory.mktemp("lights") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    model = gltf.load_file(p)
    out = {}
    for name, sky in (("cornell", None), ("sky", procedural_sky(height=16))):
        j_scene = j_build_scene(model, skybox=sky)
        out[name] = (j_scene, convert.scene_from_numpy(
            convert.to_numpy_tree(j_scene), device=CPU))
    return out


@pytest.fixture(scope="module")
def cornell_lights(scenes):
    j_scene, t_scene = scenes["cornell"]
    return jprep.prepare_lights(j_scene), tprep.prepare_lights(t_scene)


def test_prepare_lights_bit_exact(cornell_lights):
    want, got = cornell_lights
    assert got.num_local_lights == want.num_local_lights > 0
    for f in want.lights._fields:
        _same_bits(getattr(got.lights, f), getattr(want.lights, f), f)
    _same_bits(got.geometry_to_light, want.geometry_to_light)
    assert len(got.local_pdf_mips) == len(want.local_pdf_mips)
    for g, w in zip(got.local_pdf_mips, want.local_pdf_mips):
        _same_bits(g, w, "local_pdf_mips")
    assert got.env_pdf_mips is None and want.env_pdf_mips is None
    # the environment record sits after the empty infinite-light slot
    ltype = tpoly.get_light_type(got.lights.color_type_and_flags)
    assert ltype[got.num_local_lights + 1] == tpoly.K_ENVIRONMENT
    assert (ltype[:got.num_local_lights] == tpoly.K_TRIANGLE).all()


def test_prepare_lights_environment_pdf_matches_jax(scenes):
    """Under a skybox the environment pdf mips come too (the frame path
    raises for such a scene until the environment slice lands)."""
    j_scene, t_scene = scenes["sky"]
    want = jprep.prepare_lights(j_scene)
    got = tprep.prepare_lights(t_scene)
    assert len(got.env_pdf_mips) == len(want.env_pdf_mips) > 1
    for g, w in zip(got.env_pdf_mips, want.env_pdf_mips):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-7)
    _same_bits(got.lights.color_type_and_flags,
               want.lights.color_type_and_flags)


def test_scene_lights_convert_round_trip(cornell_lights):
    want, got = cornell_lights
    carried = convert.scene_lights_from_numpy(convert.to_numpy_tree(want),
                                              device=CPU)
    for a, b in zip(carried.lights, got.lights):
        _same_bits(a, b)
    assert carried.num_local_lights == got.num_local_lights


@pytest.mark.parametrize("seed", [0, 7])
def test_presample_local_lights_bit_exact(cornell_lights, seed):
    want_lights, got_lights = cornell_lights
    tiles = dict(tile_count=8, tile_size=256)
    want = jax.jit(functools.partial(jprep.presample_local_lights, **tiles),
                   static_argnums=0)(seed, want_lights)
    got = tprep.presample_local_lights(seed, got_lights, **tiles)
    assert got.shape == (8 * 256, 2)
    _same_bits(got, want)
    assert torch.equal(convert.ris_buffer_from_numpy(np.asarray(want),
                                                     device=CPU), got)
    # every slot names a real light with a positive inverse pdf
    assert (got[:, 0] < got_lights.num_local_lights).all()
    assert (got[:, 1] > 0).all()


def test_sample_and_evaluate_pdf_texture_match_jax(cornell_lights):
    want_lights, got_lights = cornell_lights
    rng = np.random.default_rng(40)
    seeds = rng.integers(0, 1 << 32, 512, dtype=np.uint32)
    j_state = jrng.RngState(seed=jnp.asarray(seeds),
                            index=jnp.ones(512, jnp.uint32))
    t_state = trng.RngState(seed=torch.from_numpy(seeds.astype(np.int64)),
                            index=torch.ones(512, dtype=torch.int64))
    want = jpdf.sample_pdf_mipmap(j_state, want_lights.local_pdf_mips, (512,))
    got = tpdf.sample_pdf_mipmap(t_state, got_lights.local_pdf_mips, (512,))
    for g, w, name in zip(got[:3], want[:3], ("x", "y", "pdf")):
        _same_bits(g, w, name)
    _same_bits(got[3].index, want[3].index, "rng index")
    h, w = got_lights.local_pdf_mips[0].shape
    x = rng.integers(0, w, 256)
    y = rng.integers(0, h, 256)
    _same_bits(tpdf.evaluate_pdf_texture(got_lights.local_pdf_mips,
                                         torch.from_numpy(x),
                                         torch.from_numpy(y)),
               jpdf.evaluate_pdf_texture(want_lights.local_pdf_mips,
                                         jnp.asarray(x), jnp.asarray(y)))


def test_fill_neighbor_offsets_bit_exact():
    _same_bits(tpdf.fill_neighbor_offsets(device=CPU),
               jpdf.fill_neighbor_offsets())


def test_triangle_light_samples_match_jax(cornell_lights):
    want_lights, got_lights = cornell_lights
    n_local = got_lights.num_local_lights
    rng = np.random.default_rng(41)
    index = rng.integers(0, n_local, 256)
    uv = rng.uniform(size=(256, 2)).astype(np.float32)
    viewer = rng.uniform(-2.0, 2.0, (256, 3)).astype(np.float32)
    got = tpoly.calc_sample(
        tpoly.gather_light(got_lights.lights, torch.from_numpy(index)),
        torch.from_numpy(uv), torch.from_numpy(viewer))
    want = jpoly.calc_sample(
        jpoly.gather_light(want_lights.lights, jnp.asarray(index)),
        jnp.asarray(uv), jnp.asarray(viewer))
    for f in want._fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert (_np(got.solid_angle_pdf) > 0).any()
    np.testing.assert_allclose(
        _np(tpoly.get_power(got_lights.lights)[:n_local]),
        _np(jpoly.get_power(want_lights.lights)[:n_local]), rtol=1e-6)


def test_light_shaping_matches_jax():
    """Spot cones from packed words (the frame's lights are unshaped, but
    every light sample goes through the shaping factor)."""
    rng = np.random.default_rng(42)
    n = 256
    flags = (rng.integers(0, 2, n) * jshape.K_SHAPING_ENABLE_BIT).astype(
        np.uint32)
    axis = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    cone = (np.float16(0.5).view(np.uint16).astype(np.uint32)
            | (np.float16(0.2).view(np.uint16).astype(np.uint32) << 16))
    cones = np.full(n, cone, np.uint32)
    ies = np.zeros(n, np.uint32)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    lpos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    j_s = jshape.unpack_light_shaping(*(jnp.asarray(a) for a in
                                        (flags, axis, cones, ies)))
    t_s = tshape.unpack_light_shaping(*(torch.from_numpy(a.astype(np.int64))
                                        for a in (flags, axis, cones, ies)))
    np.testing.assert_array_equal(_np(t_s.is_spot), _np(j_s.is_spot))
    np.testing.assert_allclose(
        _np(tshape.evaluate_light_shaping(t_s, torch.from_numpy(pos),
                                          torch.from_numpy(lpos))),
        _np(jshape.evaluate_light_shaping(j_s, jnp.asarray(pos),
                                          jnp.asarray(lpos))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tshape.get_shaping_flux_factor(t_s)),
                               _np(jshape.get_shaping_flux_factor(j_s)),
                               rtol=1e-6)


def _records_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        _same_bits(g, w, name)


@pytest.mark.parametrize("shaped", [False, True], ids=["plain", "spot"])
def test_store_point_lights_bit_exact(shaped):
    """Point-light records, with and without spot cones: every word bit for
    bit, and their samples and powers within 1e-6."""
    rng = np.random.default_rng(3)
    n = 64
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    flux = rng.uniform(0, 200, (n, 3)).astype(np.float32)
    flux[::9] = 0.0  # dark lights pack to zero words
    kw_np = {}
    if shaped:
        axis = rng.normal(size=(n, 3)).astype(np.float32)
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        kw_np = dict(cone_axis=axis,
                     cos_cone_angle=rng.uniform(0.2, 0.95, n).astype(
                         np.float32),
                     cone_softness=rng.uniform(0, 0.5, n).astype(np.float32))
    want = jpoly.store_point_lights(
        jnp.asarray(pos), jnp.asarray(flux),
        **{k: jnp.asarray(v) for k, v in kw_np.items()})
    got = tpoly.store_point_lights(
        torch.from_numpy(pos), torch.from_numpy(flux),
        **{k: torch.from_numpy(v) for k, v in kw_np.items()})
    _records_same_bits(got, want)
    viewer = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rnd = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    t_s = tpoly.calc_sample(got, torch.from_numpy(rnd),
                            torch.from_numpy(viewer))
    j_s = jpoly.calc_sample(want, jnp.asarray(rnd), jnp.asarray(viewer))
    for f in ("position", "normal", "radiance", "solid_angle_pdf"):
        np.testing.assert_allclose(_np(getattr(t_s, f)),
                                   _np(getattr(j_s, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(_np(tpoly.get_power(got)),
                               _np(jpoly.get_power(want)), rtol=1e-6)


def test_store_directional_lights_bit_exact():
    """Directional records bit for bit (oct direction, f16 half angle and
    solid angle, packed radiance), their samples within 1e-5."""
    rng = np.random.default_rng(4)
    n = 64
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rad = rng.uniform(0, 20, (n, 3)).astype(np.float32)
    half = rng.uniform(0.001, 0.3, n).astype(np.float32)
    want = jpoly.store_directional_lights(jnp.asarray(d), jnp.asarray(rad),
                                          jnp.asarray(half))
    got = tpoly.store_directional_lights(torch.from_numpy(d),
                                         torch.from_numpy(rad),
                                         torch.from_numpy(half))
    _records_same_bits(got, want)
    viewer = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rnd = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    t_s = tpoly.calc_sample(got, torch.from_numpy(rnd),
                            torch.from_numpy(viewer))
    j_s = jpoly.calc_sample(want, jnp.asarray(rnd), jnp.asarray(viewer))
    for f in ("position", "normal", "radiance", "solid_angle_pdf"):
        np.testing.assert_allclose(_np(getattr(t_s, f)),
                                   _np(getattr(j_s, f)), rtol=1e-5,
                                   atol=1e-4, err_msg=f)
