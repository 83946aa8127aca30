"""The G-buffer slice of the PyTorch port against the JAX package: the
G-buffer formats (utils/packing.py), the pixel-grid helpers of
render/rays.py, the surface helpers of render/surface.py and
render/gbuffer.py's gbuffer_pass and surface reconstruction.

The same inputs, made with numpy from a seed or carried across with
raytracer2_tpu_torch.convert, go to both packages. gbuffer_pass traces the
Cornell box at 16x16 from a camera off the box's axis, both packages through
the same clusters and bundle shape: JAX's Pallas walk in interpret mode and
the port's plain walk, whose decode rounds as XLA's fused affines, so depth
and the packed planes are bit-exact. The brute-force tracers differ in the
last bit of t (XLA fuses Moller-Trumbore's multiply-adds, torch does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import gbuffer as jgb
from raytracer2_tpu.render import rays as jrays
from raytracer2_tpu.render import surface as jsurf
from raytracer2_tpu.render.app_bridge import make_tracers as j_make_tracers
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu.utils import packing as jpk
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.render import gbuffer as tgb
from raytracer2_tpu_torch.render import rays as trays
from raytracer2_tpu_torch.render import surface as tsurf
from raytracer2_tpu_torch.render.app_bridge import make_tracers
from raytracer2_tpu_torch.utils import packing as tpk

W = H = 16
CPU = torch.device("cpu")
P = 128  # one 8x16 pixel tile per bundle
TILE_CLASS = dict(presorted=True, cull="interval", group=4, k_cand=256)


def _u32(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    p = tmp_path_factory.mktemp("gbuf") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(p))
    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    j_g = default_gconst(cam.planar_view_constants(),
                         j_scene.num_emissive_triangles, enable_restir_gi=0)
    # a moved previous camera, so motion vectors are not all zero
    prev = default_camera(window_size=(W, H), position=(0.3, 0.0, -12.5),
                          direction=(0.02, 0, -1))
    j_g = j_g.replace(prev_view=prev.planar_view_constants())
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_g = convert.gconst_from_numpy(convert.to_numpy_tree(j_g))
    return j_scene, j_g, t_scene, t_g


@pytest.fixture(scope="module")
def gbuffers(cornell):
    """Both packages' gbuffer_pass through the bundle walk on the same
    clusters (4 triangles each): JAX's Pallas walk in interpret mode, the
    port's plain walk."""
    j_scene, j_g, t_scene, t_g = cornell
    jc = jcluster.build_clusters(j_scene.tri_v0, j_scene.tri_edge1,
                                 j_scene.tri_edge2, cluster_size=4)
    tc = convert.clusters_from_numpy(convert.to_numpy_tree(jc), device=CPU)
    tables = ct.build_tables(tc, t_scene.tri_geometry, t_scene.tri_primitive)
    smin, smax = jnp.min(jc.aabb_min, 0), jnp.max(jc.aabb_max, 0)

    def j_trace(o, d, t_min, t_max, presorted=False):
        assert presorted
        return ptm.closest_hit_bundle_pallas(
            jc, j_scene.tri_geometry, j_scene.tri_primitive, o, d, t_min,
            t_max, smin, smax, bundle_size=P, interpret=True, mb=1,
            **TILE_CLASS)

    def t_trace(o, d, t_min, t_max, presorted=False):
        assert presorted
        return ct.closest_hit_bundle(
            tc, tables, o, d, t_min, t_max, torch.tensor(np.asarray(smin)),
            torch.tensor(np.asarray(smax)), bundle_size=P, **TILE_CLASS)[0]

    want = jgb.gbuffer_pass(j_scene, j_g, j_trace, W, H)
    got = tgb.gbuffer_pass(t_scene, t_g, t_trace, W, H)
    return want, got


def _assert_gbuffer_matches(got, want, exact_depth: bool):
    (gb, motion), (jgbuf, jmotion) = got, want
    depth = np.asarray(jgbuf.depth)
    assert (depth < 1e5).sum() > W * H // 2  # the box fills the view
    if exact_depth:
        np.testing.assert_array_equal(_bits(gb.depth), _bits(depth))
    else:  # brute force: t within an ulp
        np.testing.assert_allclose(gb.depth.numpy(), depth, rtol=1e-6)
    for f in ("normals", "geo_normals", "diffuse_albedo", "specular_rough"):
        np.testing.assert_array_equal(_u32(getattr(gb, f)),
                                      _u32(getattr(jgbuf, f)), err_msg=f)
    np.testing.assert_allclose(gb.emissive.numpy(), np.asarray(jgbuf.emissive),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(motion.numpy(), np.asarray(jmotion),
                               rtol=2e-3, atol=2e-3)
    assert np.abs(np.asarray(jmotion)).max() > 0.1  # the camera moved


def test_gbuffer_pass_matches_jax_bit_exact(gbuffers):
    want, got = gbuffers
    _assert_gbuffer_matches(got, want, exact_depth=True)


def test_gbuffer_pass_brute_tracers_match_jax(cornell):
    j_scene, j_g, t_scene, t_g = cornell
    want = jgb.gbuffer_pass(j_scene, j_g,
                            j_make_tracers(j_scene, backend="brute")
                            .closest_hit, W, H)
    got = tgb.gbuffer_pass(t_scene, t_g,
                           make_tracers(t_scene, backend="brute").closest_hit,
                           W, H)
    _assert_gbuffer_matches(got, want, exact_depth=False)


def _surfaces_close(got, want):
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_surface_from_gbuffer_grid_matches_jax(cornell, gbuffers):
    """The same packed planes (JAX's, carried across) give the same
    surfaces over the whole launch grid."""
    _, j_g, _, t_g = cornell
    (jgbuf, _), _ = gbuffers
    tgbuf = convert.gbuffer_from_numpy(convert.to_numpy_tree(jgbuf),
                                       device=CPU)
    _surfaces_close(tgb.surface_from_gbuffer_grid(tgbuf, t_g.view),
                    jgb.surface_from_gbuffer_grid(jgbuf, j_g.view))


def test_surface_from_gbuffer_gathers_match_jax_and_grid(cornell, gbuffers):
    """Gathered pixels, some out of view (invalid surfaces), against JAX;
    in-view pixels equal the grid reconstruction at those pixels."""
    _, j_g, _, t_g = cornell
    (jgbuf, _), _ = gbuffers
    tgbuf = convert.gbuffer_from_numpy(convert.to_numpy_tree(jgbuf),
                                       device=CPU)
    rng = np.random.default_rng(21)
    px = rng.integers(-3, W + 3, 64).astype(np.int32)
    py = rng.integers(-3, H + 3, 64).astype(np.int32)
    got = tgb.surface_from_gbuffer(tgbuf, t_g.view, torch.from_numpy(px),
                                   torch.from_numpy(py), W, H)
    want = jgb.surface_from_gbuffer(jgbuf, j_g.view, jnp.asarray(px),
                                    jnp.asarray(py), W, H)
    _surfaces_close(got, want)
    grid = tgb.surface_from_gbuffer_grid(tgbuf, t_g.view)
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    assert 0 < inside.sum() < inside.size
    for f in grid._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[inside],
            getattr(grid, f).numpy()[py[inside], px[inside]], err_msg=f)


# ---------------------------------------------------------------------------
# G-buffer formats
# ---------------------------------------------------------------------------

def _unit_vectors(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[:6] = np.float32([[1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                        [-1, 0, 0], [0, 1, 0]])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_octahedral_normals_bit_exact():
    n = _unit_vectors(512, 22)
    packed = tpk.ndir_to_oct_unorm32(torch.from_numpy(n))
    np.testing.assert_array_equal(_u32(packed),
                                  _u32(jpk.ndir_to_oct_unorm32(jnp.asarray(n))))
    # the decode's float math: XLA fuses its multiply-adds, torch does not
    words = _u32(packed)
    np.testing.assert_allclose(
        tpk.oct_unorm32_to_ndir(torch.from_numpy(words)).numpy(),
        np.asarray(jpk.oct_unorm32_to_ndir(jnp.asarray(words, jnp.uint32))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["r11g11b10", "rgba8_gamma"])
def test_colour_formats_bit_exact(fmt):
    rng = np.random.default_rng(23)
    width = 3 if fmt == "r11g11b10" else 4
    x = rng.uniform(0.0, 1.2, (512, width)).astype(np.float32)
    x[:8] = [[0.0] * width, [1.0] * width, [1e-7] * width, [6e4] * width,
             [0.5] * width, [2.0] * width, [1e-3] * width, [0.25] * width]
    pack, unpack = f"pack_{fmt}_ufloat", f"unpack_{fmt}_ufloat"
    packed = getattr(tpk, pack)(torch.from_numpy(x))
    np.testing.assert_array_equal(_u32(packed),
                                  _u32(getattr(jpk, pack)(jnp.asarray(x))))
    # unpacking rgba8_gamma raises to the power 2.2: the two libraries'
    # pow may differ in the last bit
    words = _u32(packed)
    np.testing.assert_allclose(
        getattr(tpk, unpack)(torch.from_numpy(words)).numpy(),
        np.asarray(getattr(jpk, unpack)(jnp.asarray(words, jnp.uint32))),
        rtol=1e-6, atol=0)


def test_f16_bits_and_zcurve_bit_exact():
    rng = np.random.default_rng(24)
    x = rng.normal(scale=100.0, size=512).astype(np.float32)
    x[:5] = [0.0, -0.0, 65504.0, 1e-8, 7e4]
    bits = tpk.f32_to_f16_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(_u32(bits),
                                  _u32(jpk.f32_to_f16_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _bits(tpk.f16_bits_to_f32(torch.from_numpy(_u32(bits)))),
        _bits(jpk.f16_bits_to_f32(jnp.asarray(_u32(bits), jnp.uint32))))
    index = rng.integers(0, 1 << 24, 512).astype(np.int64)
    for g, w in zip(tpk.linear_to_zcurve(torch.from_numpy(index)),
                    jpk.linear_to_zcurve(jnp.asarray(index, jnp.uint32))):
        np.testing.assert_array_equal(_u32(g), _u32(w))


# ---------------------------------------------------------------------------
# Pixel-grid and surface helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", [0, 1, 2])
def test_checkerboard_fields_match_jax(field):
    img = np.random.default_rng(25).uniform(size=(H, W, 3)).astype(np.float32)
    gx, gy = trays.active_pixel_grid(W, H, field, device=CPU)
    jx, jy = jrays.active_pixel_grid(W, H, field)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))
    half = trays.gather_field(torch.from_numpy(img), field)
    np.testing.assert_array_equal(
        half.numpy(), np.asarray(jrays.gather_field(jnp.asarray(img), field)))
    np.testing.assert_array_equal(half.numpy(),
                                  img[gy.numpy(), gx.numpy()])
    new = half.numpy() + 1.0
    np.testing.assert_array_equal(
        trays.scatter_field(torch.from_numpy(img), torch.from_numpy(new),
                            field).numpy(),
        np.asarray(jrays.scatter_field(jnp.asarray(img), jnp.asarray(new),
                                       field)))


def test_tile_layout_matches_jax():
    assert trays.tile_shape(W, H) == jrays.tile_shape(W, H) == (8, 16)
    assert trays.tile_shape(W + 1, H) is None
    img = np.arange(H * W * 2, dtype=np.float32).reshape(H, W, 2)
    flat = trays.tile_flatten(torch.from_numpy(img), 16)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jrays.tile_flatten(jnp.asarray(img), 16)))
    np.testing.assert_array_equal(
        trays.tile_unflatten(flat, H, W, 16).numpy(), img)
    np.testing.assert_array_equal(trays.tile_permutation(W, H, 16),
                                  np.asarray(jrays.tile_permutation(W, H,
                                                                    16)))


def test_world_position_and_motion_match_jax(cornell):
    _, j_g, _, t_g = cornell
    rng = np.random.default_rng(26)
    px = rng.integers(0, W, 64).astype(np.int32)
    py = rng.integers(0, H, 64).astype(np.int32)
    depth = rng.uniform(1.0, 30.0, 64).astype(np.float32)
    got = trays.view_depth_to_world_pos(t_g.view, torch.from_numpy(px),
                                        torch.from_numpy(py),
                                        torch.from_numpy(depth))
    want = jrays.view_depth_to_world_pos(j_g.view, jnp.asarray(px),
                                         jnp.asarray(py), jnp.asarray(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    prev = got + torch.from_numpy(rng.normal(scale=0.1, size=(64, 3))
                                  .astype(np.float32))
    np.testing.assert_allclose(
        trays.get_motion_vector(t_g.view, t_g.prev_view, got, prev).numpy(),
        np.asarray(jrays.get_motion_vector(j_g.view, j_g.prev_view,
                                           jnp.asarray(got.numpy()),
                                           jnp.asarray(prev.numpy()))),
        rtol=1e-4, atol=1e-4)


def _random_surfaces(n, seed):
    rng = np.random.default_rng(seed)
    normal = _unit_vectors(n, seed)
    view_dir = _unit_vectors(n, seed + 1)
    arrays = dict(
        world_pos=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
        view_dir=view_dir,
        view_depth=rng.uniform(1, 20, n).astype(np.float32),
        normal=normal, geo_normal=normal,
        diffuse_albedo=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        specular_f0=rng.uniform(0, 0.2, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0, 1, n).astype(np.float32),
        diffuse_probability=rng.uniform(0, 1, n).astype(np.float32))
    arrays["roughness"][:8] = 0.0  # the perfect-mirror branch
    return (tsurf.Surface(**{k: torch.from_numpy(v)
                             for k, v in arrays.items()}),
            jsurf.Surface(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def test_surface_brdf_helpers_match_jax():
    t_s, j_s = _random_surfaces(256, 27)
    rng = np.random.default_rng(28)
    target = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    got = tsurf.evaluate_brdf(t_s, torch.from_numpy(target))
    want = jsurf.evaluate_brdf(j_s, jnp.asarray(target))
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    direction = _unit_vectors(256, 29)
    np.testing.assert_allclose(
        tsurf.get_surface_brdf_pdf(t_s, torch.from_numpy(direction)).numpy(),
        np.asarray(jsurf.get_surface_brdf_pdf(j_s, jnp.asarray(direction))),
        rtol=1e-5, atol=1e-6)
    # a surface against itself shifted by one lane, and against itself
    t_b = tsurf.Surface(*(torch.roll(x, 1, 0) for x in t_s))
    j_b = jsurf.Surface(*(jnp.roll(x, 1, 0) for x in j_s))
    similar = tsurf.are_materials_similar(t_s, t_b).numpy()
    np.testing.assert_array_equal(
        similar, np.asarray(jsurf.are_materials_similar(j_s, j_b)))
    assert tsurf.are_materials_similar(t_s, t_s).numpy().all()


def test_clamp_sample_position_into_view_matches_jax():
    rng = np.random.default_rng(30)
    px = rng.integers(-20, W + 20, 128).astype(np.int32)
    py = rng.integers(-20, H + 20, 128).astype(np.int32)
    got = tsurf.clamp_sample_position_into_view(
        torch.from_numpy(px), torch.from_numpy(py), W, H)
    want = jsurf.clamp_sample_position_into_view(jnp.asarray(px),
                                                 jnp.asarray(py), W, H)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
