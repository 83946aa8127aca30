"""Foundations of the PyTorch port against the JAX package: Z-curve packing
and the RNG bit for bit (on the inputs of test_packing.py and test_rng.py
plus seeded random words), the BRDF sample within 1e-6, and the camera's
view constants and the default GConst field by field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu import params as jparams
from raytracer2_tpu.render import surface as jsurf
from raytracer2_tpu.scene import camera as jcam
from raytracer2_tpu.utils import brdf as jbrdf
from raytracer2_tpu.utils import packing as jpk
from raytracer2_tpu.utils import rng as jrng
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch import params as tparams
from raytracer2_tpu_torch.render import surface as tsurf
from raytracer2_tpu_torch.scene import camera as tcam
from raytracer2_tpu_torch.utils import brdf as tbrdf
from raytracer2_tpu_torch.utils import packing as tpk
from raytracer2_tpu_torch.utils import rng as trng

WORDS = np.concatenate([
    np.asarray([0, 1, 2, 0xFF, 0xABCD, 0xFFFF, 12345, 123456789,
                0xCAFEBABE, 0xDEADBEEF, 0xFFFFFFFF], np.uint32),
    np.random.default_rng(5).integers(0, 1 << 32, 512, dtype=np.uint32)])


def _j(x):
    return jnp.asarray(x, jnp.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _u32(x):
    """Either package's integer result as uint32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.uint32)


def _f32_bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("mask", [0xFFFF, 0xFFFFFFFF], ids=["16bit", "32bit"])
def test_integer_explode_bit_exact(mask):
    words = WORDS & mask
    np.testing.assert_array_equal(_u32(tpk.integer_explode(_t(words))),
                                  _u32(jpk.integer_explode(_j(words))))


def test_zcurve_to_linear_bit_exact():
    xs = np.concatenate([np.arange(0, 256, 7), WORDS[:64] & 0xFFFF])
    ys = np.concatenate([np.arange(3, 259, 7) % 256, WORDS[64:128] & 0xFFFF])
    want = jpk.zcurve_to_linear(_j(xs), _j(ys))
    got = tpk.zcurve_to_linear(_t(xs), _t(ys))
    np.testing.assert_array_equal(_u32(got), _u32(want))


def test_jenkins_hash_bit_exact():
    np.testing.assert_array_equal(_u32(trng.jenkins_hash(_t(WORDS))),
                                  _u32(jrng.jenkins_hash(_j(WORDS))))


def test_murmur3_and_uniforms_bit_exact():
    index = np.random.default_rng(6).integers(0, 1 << 32, WORDS.size,
                                              dtype=np.uint32)
    index[:4] = [1, 2, 0xFFFFFFFF, 0]
    j_state = jrng.RngState(seed=_j(WORDS), index=_j(index))
    t_state = trng.RngState(seed=_t(WORDS), index=_t(index))
    for _ in range(3):
        j_bits, j_state = jrng.murmur3(j_state)
        t_bits, t_state = trng.murmur3(t_state)
        np.testing.assert_array_equal(_u32(t_bits), _u32(j_bits))
    j_u, j_state = jrng.sample_uniform_n(j_state, 3)
    t_u, t_state = trng.sample_uniform_n(t_state, 3)
    np.testing.assert_array_equal(_f32_bits(t_u), _f32_bits(j_u))
    np.testing.assert_array_equal(_u32(t_state.index), _u32(j_state.index))


def test_init_random_sampler_bit_exact():
    rng = np.random.default_rng(7)
    px = rng.integers(0, 3840, 256).astype(np.uint32)
    py = rng.integers(0, 2160, 256).astype(np.uint32)
    for frame in (0, 13, 0xFFFFFFF0):
        want = jrng.init_random_sampler(_j(px), _j(py), frame)
        got = trng.init_random_sampler(_t(px), _t(py), frame)
        np.testing.assert_array_equal(_u32(got.seed), _u32(want.seed))
        np.testing.assert_array_equal(_u32(got.index), _u32(want.index))


def test_pcg_next_random_bit_exact():
    state = np.arange(1, 1025, dtype=np.uint32) * np.uint32(2654435761)
    want_v, want_s = jrng.random_value(_j(state))
    got_v, got_s = trng.random_value(_t(state))
    np.testing.assert_array_equal(_u32(got_s), _u32(want_s))
    np.testing.assert_array_equal(_f32_bits(got_v), _f32_bits(want_v))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("diffuse_probability", [1.0, 0.5, 0.0])
def test_brdf_sample_matches_jax(diffuse_probability):
    """RAB_GetSurfaceBrdfSample: the cosine lobe, the GGX-VNDF lobe and the
    lobe choice; the RNG state must come back bit for bit.

    The cosine lobe (the only one the reference frame draws: its diffuse
    probability is fixed at 1) agrees within 1e-6. The GGX-VNDF lobe is
    ill-conditioned where the disk sample nears the rim: sqrt(1 - p1^2 -
    p2^2) turns the one-ulp difference between the two packages' sin and
    cos into up to ~5e-3 in the direction. Its lanes are held to 1e-6 on
    at least 95% of them and to 1e-2 on all."""
    rng = np.random.default_rng(8)
    n = 512
    normal = _unit(rng, n)
    view = _unit(rng, n)
    fields = dict(
        world_pos=rng.normal(size=(n, 3)).astype(np.float32),
        view_dir=view, view_depth=np.full(n, 5.0, np.float32),
        normal=normal, geo_normal=normal,
        diffuse_albedo=rng.uniform(size=(n, 3)).astype(np.float32),
        specular_f0=rng.uniform(size=(n, 3)).astype(np.float32),
        roughness=rng.uniform(0.0, 1.0, n).astype(np.float32),
        diffuse_probability=np.full(n, diffuse_probability, np.float32))
    seed = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    want_dir, want_ok, want_state = jsurf.get_surface_brdf_sample(
        jsurf.Surface(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jrng.RngState(seed=_j(seed), index=_j(np.ones(n, np.uint32))))
    got_dir, got_ok, got_state = tsurf.get_surface_brdf_sample(
        tsurf.Surface(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        trng.RngState(seed=_t(seed), index=_t(np.ones(n, np.uint32))))
    np.testing.assert_array_equal(_u32(got_state.index),
                                  _u32(want_state.index))
    err = np.abs(got_dir.numpy() - np.asarray(want_dir)).max(axis=-1)
    diffuse = trng.sample_uniform(trng.RngState(
        seed=_t(seed), index=_t(np.ones(n, np.uint32))))[0].numpy() \
        < diffuse_probability
    assert np.all(err[diffuse] <= 1e-6)
    if not diffuse.all():
        assert np.mean(err[~diffuse] <= 1e-6) >= 0.95
        assert np.all(err[~diffuse] <= 1e-2)
    flips = got_ok.numpy() != np.asarray(want_ok)
    assert not flips[diffuse].any()
    assert np.all(np.abs(np.sum(np.asarray(want_dir) * normal, -1))[flips]
                  < 1e-2)


def test_ggx_d_keeps_macro_quirk():
    assert tbrdf.GGX_MACRO_QUIRK == jbrdf.GGX_MACRO_QUIRK
    rng = np.random.default_rng(9)
    noh = rng.uniform(0.0, 1.0, 256).astype(np.float32)
    alpha = rng.uniform(0.01, 1.0, 256).astype(np.float32)
    for quirk in (True, False):
        want = jbrdf.ggx_d(jnp.asarray(noh), jnp.asarray(alpha), quirk=quirk)
        got = tbrdf.ggx_d(torch.from_numpy(noh), torch.from_numpy(alpha),
                          quirk=quirk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


CAMERAS = [
    dict(window_size=(16, 16), position=(0.13, 0.07, -12),
         direction=(0, 0, -1)),
    dict(window_size=(1920, 1080), position=(0, 4, 90), direction=(0, 0, 1)),
]


@pytest.mark.parametrize("cam", CAMERAS, ids=["cornell", "ladder"])
def test_planar_view_constants_field_by_field(cam):
    want = jcam.default_camera(**cam).planar_view_constants()
    got = tcam.default_camera(**cam).planar_view_constants()
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _assert_tree_equal(got, want, path="g"):
    if dataclasses.is_dataclass(want) or hasattr(want, "_fields"):
        names = (want._fields if hasattr(want, "_fields")
                 else [f.name for f in dataclasses.fields(want)])
        for name in names:
            _assert_tree_equal(getattr(got, name), getattr(want, name),
                               f"{path}.{name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        want = np.asarray(want)
        np.testing.assert_array_equal(np.asarray(got, want.dtype), want,
                                      err_msg=path)


def test_default_gconst_field_by_field():
    cam = jcam.default_camera(**CAMERAS[0])
    want = jparams.default_gconst(cam.planar_view_constants(), 7,
                                  refrence_mode=1)
    got = tparams.default_gconst(
        tcam.default_camera(**CAMERAS[0]).planar_view_constants(), 7,
        refrence_mode=1)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    _assert_tree_equal(got, want)
    # and the conversion of the JAX GConst gives the same object
    _assert_tree_equal(convert.gconst_from_numpy(convert.to_numpy_tree(want)),
                       want)
    assert tparams.BACKGROUND_DEPTH == jparams.BACKGROUND_DEPTH


def test_empty_surface_matches_jax():
    want = jsurf.empty_surface((3, 5))
    got = tsurf.empty_surface((3, 5), device=torch.device("cpu"))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert not got.valid.any()


def test_brdf_leftovers_match_jax():
    """importance_sample_ggx, basic_tone_mapping and the spherical
    coordinates (round trip included) within 1e-6 (XLA's and torch's
    library sin, cos, atan2 and asin may differ by an ulp)."""
    rng = np.random.default_rng(17)
    n = 1024
    rnd = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    np.testing.assert_allclose(
        tbrdf.importance_sample_ggx(torch.from_numpy(rnd),
                                    torch.from_numpy(rough)).numpy(),
        np.asarray(jbrdf.importance_sample_ggx(jnp.asarray(rnd),
                                               jnp.asarray(rough))),
        rtol=1e-6, atol=1e-6)
    color = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    color[::7] = 0.0  # zero luminance keeps its colour
    bias = rng.uniform(0.1, 2, n).astype(np.float32)
    np.testing.assert_allclose(
        tbrdf.basic_tone_mapping(torch.from_numpy(color),
                                 torch.from_numpy(bias)).numpy(),
        np.asarray(jbrdf.basic_tone_mapping(jnp.asarray(color),
                                            jnp.asarray(bias))),
        rtol=1e-6, atol=1e-7)
    v = (rng.normal(size=(n, 3)) * rng.uniform(0.1, 10, (n, 1))).astype(
        np.float32)
    got = tbrdf.cartesian_to_spherical(torch.from_numpy(v))
    want = jbrdf.cartesian_to_spherical(jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    back = tbrdf.spherical_to_cartesian(*got)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jbrdf.spherical_to_cartesian(*want)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), v, rtol=1e-4, atol=1e-4)


def test_ray_aabb_matches_jax():
    """The slab test's hit mask bit for bit and its entry t within 1e-6,
    on axis-parallel rays (safe_inv_dir) too."""
    from raytracer2_tpu.ops import intersect as jint
    from raytracer2_tpu_torch.ops import intersect as tint

    rng = np.random.default_rng(23)
    n = 2048
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::5, rng.integers(0, 3)] = 0.0  # parallel to a slab
    lo = rng.uniform(-2, 1, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (n, 3)).astype(np.float32)
    t_min, t_max = 1e-3, rng.uniform(0.5, 10, n).astype(np.float32)
    inv_t = tint.safe_inv_dir(torch.from_numpy(d))
    inv_j = jint.safe_inv_dir(jnp.asarray(d))
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    hit, entry = tint.ray_aabb(torch.from_numpy(o), inv_t,
                               torch.from_numpy(lo), torch.from_numpy(hi),
                               t_min, torch.from_numpy(t_max))
    j_hit, j_entry = jint.ray_aabb(jnp.asarray(o), inv_j, jnp.asarray(lo),
                                   jnp.asarray(hi), t_min,
                                   jnp.asarray(t_max))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(j_hit))
    assert 0 < hit.sum() < n
    np.testing.assert_allclose(entry.numpy(), np.asarray(j_entry),
                               rtol=1e-6, atol=1e-6)
