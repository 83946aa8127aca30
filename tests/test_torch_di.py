"""The ReSTIR DI slice of the PyTorch port against the JAX package: the DI
fused resampling pass (render/di_passes.py, mode 0) and whole DI frames of
render_frame with GI off, in bench.py's DI validation config (4 local-light
candidates from the RIS tiles, 1 BRDF candidate, final visibility,
accumulation).

Both packages render the Cornell box at 16x16 from a camera off the box's
axis, tracing through the same clusters with the same bundle shapes: JAX's
Pallas walks in interpret mode, the port's plain walks, so every hit and
every visibility flag is the same. Display, diffuse and specular agree
within rtol=atol=2e-3, the G-buffer planes bit for bit and the reservoirs
within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import di_passes as jdi
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render import gbuffer as jgb
from raytracer2_tpu.render.app_bridge import Tracers as JTracers
from raytracer2_tpu.render.app_bridge import make_bridge as j_make_bridge
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.render import app_bridge as tab
from raytracer2_tpu_torch.render import di_passes as tdi
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.render import gbuffer as tgb

W = H = 16
CPU = torch.device("cpu")
FRAMES = 2


def di_gconst(view, n_lights, **overrides):
    """bench.py:667-676: "restir-di 4NEE+1BRDF finalvis"."""
    g = default_gconst(view, n_lights, enable_restir_di=1, enable_restir_gi=0,
                       enable_accumulation=1, correct_specular_accumulation=1,
                       **overrides)
    di = g.restir_di
    isp = dataclasses.replace(di.initial_sampling_params,
                              num_primary_local_light_samples=4)
    shp = dataclasses.replace(di.shading_params, enable_final_visibility=1)
    return g.replace(restir_di=dataclasses.replace(
        di, initial_sampling_params=isp, shading_params=shp))


def _j_pallas_tracers(port_tracers, j_scene) -> JTracers:
    """JAX's Pallas walks (interpret mode) over the port's clusters, with
    the port's per-class shapes."""
    c = port_tracers.clusters
    jc = jcluster.Clusters(*(jnp.asarray(x.numpy()) for x in c))
    smin = jnp.asarray(port_tracers.scene_min.numpy())
    smax = jnp.asarray(port_tracers.scene_max.numpy())
    shapes = port_tracers.shapes_by_class

    def closest(o, d, tmin, tmax, presorted=False):
        return ptm.closest_hit_bundle_pallas(
            jc, j_scene.tri_geometry, j_scene.tri_primitive, o, d, tmin,
            tmax, smin, smax, interpret=True, mb=1,
            presorted=bool(presorted), **shapes[bool(presorted)])

    def occluded(o, d, tmin, tmax, presorted=False):
        cls = presorted if presorted == "shadow" else bool(presorted)
        return ptm.occluded_bundle_pallas(
            jc, o, d, tmin, tmax, smin, smax, interpret=True, mb=1,
            presorted=bool(presorted), **shapes[cls])

    return JTracers(closest_hit=closest, occluded=occluded)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    p = tmp_path_factory.mktemp("di") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(p))
    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    j_g = di_gconst(cam.planar_view_constants(),
                    j_scene.num_emissive_triangles)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_renderer = tframe.create_renderer(t_scene, W, H)
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_pallas_tracers(t_renderer.tracers, j_scene))
    return dict(j_scene=j_scene, j_g=j_g, t_scene=t_scene,
                j_renderer=j_renderer, t_renderer=t_renderer)


def _t_g(j_g):
    return convert.gconst_from_numpy(convert.to_numpy_tree(j_g))


def _frame_g(j_g, f):
    return j_g.replace(frame=f, blend_factor=1.0 / (f + 1))


@pytest.fixture(scope="module")
def frames(cornell):
    """FRAMES DI frames of render_frame in both packages from fresh states:
    [(JAX state, JAX display, port state, port display)] per frame."""
    j_state = jframe.init_frame_state(W, H)
    t_state = tframe.init_frame_state(W, H, device=CPU)
    out = []
    for f in range(FRAMES):
        g = _frame_g(cornell["j_g"], f)
        j_state, j_img = jframe.render_frame(cornell["j_renderer"], g,
                                             j_state)
        t_state, t_img = tframe.render_frame(cornell["t_renderer"], _t_g(g),
                                             t_state)
        out.append((j_state, j_img, t_state, t_img))
    return out


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and (got >= 0).all(), name
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=name)


def _reservoir_differences(got, want) -> int:
    """Values of the DI reservoirs that differ beyond rtol=atol=1e-5."""
    n = 0
    for f in want._fields:
        a = np.asarray(getattr(want, f)).astype(np.float64)
        b = getattr(got, f).numpy().astype(np.float64)
        n += int((~np.isclose(b, a, rtol=1e-5, atol=1e-5)).sum())
    return n


@pytest.mark.parametrize("frame", range(FRAMES))
def test_render_frame_di_matches_jax(frames, frame):
    j_state, j_img, t_state, t_img = frames[frame]
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05  # lit, not black
    assert float(np.asarray(j_state.diffuse_lighting).mean()) > 0.1
    for f in ("depth", "normals", "diffuse_albedo", "specular_rough"):
        np.testing.assert_array_equal(
            getattr(t_state.gbuffer, f).numpy(),
            np.asarray(getattr(j_state.gbuffer, f)).astype(
                getattr(t_state.gbuffer, f).numpy().dtype), err_msg=f)
    # the shading slot holds this frame's reservoirs
    slot = 0
    n = _reservoir_differences(t_state.di_reservoirs[slot],
                               j_state.di_reservoirs[slot])
    assert n == 0, f"{n} reservoir values differ"


def test_di_reservoirs_carry_across(frames):
    """convert.di_reservoir_from_numpy gives the port's reservoirs from
    JAX's, field for field."""
    j_state, _, t_state, _ = frames[-1]
    for j_res, t_res in zip(j_state.di_reservoirs, t_state.di_reservoirs):
        carried = convert.di_reservoir_from_numpy(convert.to_numpy_tree(j_res),
                                                  device=CPU)
        for f in t_res._fields:
            a, b = getattr(carried, f), getattr(t_res, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f)


def test_di_frames_accumulate(frames):
    """blend_factor 1/(f+1): the second frame averages both frames."""
    (_, _, s0, _), (_, _, s1, _) = frames[:2]
    assert not torch.equal(s0.diffuse_lighting, s1.diffuse_lighting)
    assert torch.equal(s1.prev_gbuffer.depth, s0.gbuffer.depth)


def test_di_fused_resampling_pass_matches_jax(cornell, frames):
    """The pass alone, from the same G-buffer (JAX's, carried across) and
    the same prior lighting images."""
    j_state = frames[0][0]
    g = _frame_g(cornell["j_g"], 1)
    t_g = _t_g(g)
    jr, tr = cornell["j_renderer"], cornell["t_renderer"]
    t_gbuf = convert.gbuffer_from_numpy(convert.to_numpy_tree(
        j_state.gbuffer), device=CPU)
    prior = [np.array(x) for x in (j_state.diffuse_lighting,
                                     j_state.specular_lighting)]

    jl = jr.scene_lights
    j_bridge = j_make_bridge(
        cornell["j_scene"], jr.tracers, j_state.gbuffer, j_state.gbuffer, g,
        jl.lights, jl.geometry_to_light, jl.local_pdf_mips, jl.env_pdf_mips,
        jr.neighbor_offsets, W, H)
    want = jdi.di_fused_resampling_pass(
        g, j_bridge, jr.light_ctx(g), *map(jnp.asarray, prior), W, H,
        primary_surface=jgb.surface_from_gbuffer_grid(j_state.gbuffer,
                                                      g.view))
    tl = tr.scene_lights
    t_bridge = tab.make_bridge(
        cornell["t_scene"], tr.tracers, t_gbuf, t_gbuf, t_g, tl.lights,
        tl.geometry_to_light, tl.local_pdf_mips, tl.env_pdf_mips,
        tr.neighbor_offsets, W, H)
    got = tdi.di_fused_resampling_pass(
        t_g, t_bridge, tr.light_ctx(t_g), *map(torch.from_numpy, prior), W,
        H, primary_surface=tgb.surface_from_gbuffer_grid(t_gbuf, t_g.view))
    _close(got[1], want[1], "diffuse")
    _close(got[2], want[2], "specular")
    assert _reservoir_differences(got[0], want[0]) == 0
    # every visible pixel drew a light
    assert (got[0].weight_sum > 0).float().mean() > 0.5


def test_di_pass_row_bands_change_nothing(cornell, monkeypatch):
    """Above _BAND_THRESHOLD lanes the pass body runs in row bands; every
    RNG stream is seeded by pixel coordinates, so the bands change no
    value."""
    tr = cornell["t_renderer"]
    t_g = _t_g(_frame_g(cornell["j_g"], 0))
    state = tframe.init_frame_state(W, H, device=CPU)
    _, whole = tframe.render_frame(tr, t_g, state)
    monkeypatch.setattr(tdi, "_BAND_THRESHOLD", 2 * W * 3)  # bands of 3 rows
    _, banded = tframe.render_frame(tr, t_g, state)
    np.testing.assert_array_equal(banded.numpy(), whole.numpy())


def test_di_frame_counts_walks_and_fallbacks(cornell, monkeypatch):
    """On a CPU scene the wrappers run the plain walks (no launch counted);
    the tracers count fallback bundles per ray class."""
    monkeypatch.setattr(tab, "K_CAND", 1)
    monkeypatch.setattr(tab, "CLUSTER_SIZE", 4)
    tr = tframe.create_renderer(cornell["t_scene"], W, H)
    before = ct.walk_closest.launches, ct.walk_occluded.launches
    _, img = tframe.render_frame(tr, _t_g(_frame_g(cornell["j_g"], 0)),
                                 tframe.init_frame_state(W, H, device=CPU))
    assert (ct.walk_closest.launches, ct.walk_occluded.launches) == before
    assert set(tr.tracers.fallback_by_class) == {True, False}
    assert tr.tracers.fallback_bundles > 0
    # the fallback keeps the frame exact
    _, want = tframe.render_frame(cornell["t_renderer"],
                                  _t_g(_frame_g(cornell["j_g"], 0)),
                                  tframe.init_frame_state(W, H, device=CPU))
    np.testing.assert_allclose(img.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The reservoir library and the resampling helpers, on seeded random inputs
# ---------------------------------------------------------------------------

def _random_reservoir(rng, n):
    """One DI reservoir per lane, as numpy fields (uint32 as int64)."""
    valid = rng.uniform(size=n) < 0.7
    return dict(
        light_data=np.where(valid, rng.integers(0, 50, n) | 0x80000000, 0),
        uv_data=rng.integers(0, 1 << 32, n),
        weight_sum=rng.uniform(0, 3, n).astype(np.float32),
        target_pdf=np.where(rng.uniform(size=n) < 0.2, 0.0,
                            rng.uniform(0, 2, n)).astype(np.float32),
        m=rng.integers(1, 5, n).astype(np.float32),
        packed_visibility=rng.integers(0, 1 << 18, n),
        spatial_distance=rng.integers(-3, 4, (n, 2)).astype(np.int32),
        age=rng.integers(0, 6, n),
        canonical_weight=rng.uniform(0, 1, n).astype(np.float32))


def _both_reservoirs(fields):
    from raytracer2_tpu.restir import di_reservoir as jres
    from raytracer2_tpu_torch.restir import di_reservoir as tres

    j = jres.DIReservoir(**{
        k: jnp.asarray(v.astype(np.uint32) if v.dtype == np.int64 else v)
        for k, v in fields.items()})
    t = convert.di_reservoir_from_numpy(fields, device=CPU)
    return jres, tres, j, t


def _assert_reservoirs_equal(got, want):
    for f in want._fields:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=f)
        else:
            np.testing.assert_array_equal(b.astype(np.int64) & 0xFFFFFFFF,
                                          a.astype(np.int64) & 0xFFFFFFFF,
                                          err_msg=f)


def test_di_reservoir_library_bit_exact():
    """Stream, combine, finalize, store and read visibility, in both
    packages, bit for bit."""
    rng = np.random.default_rng(50)
    n = 512
    jres, tres, j, t = _both_reservoirs(_random_reservoir(rng, n))
    index = rng.integers(0, 50, n)
    uv = rng.uniform(-0.1, 1.1, (n, 2)).astype(np.float32)
    rnd = rng.uniform(size=n).astype(np.float32)
    tpdf = rng.uniform(0, 2, n).astype(np.float32)
    inv = rng.uniform(0, 4, n).astype(np.float32)
    active = rng.uniform(size=n) < 0.6

    j1, jsel = jres.stream_sample(j, jnp.asarray(index, jnp.uint32),
                                  jnp.asarray(uv), jnp.asarray(rnd),
                                  jnp.asarray(tpdf), jnp.asarray(inv),
                                  active=jnp.asarray(active))
    t1, tsel = tres.stream_sample(t, torch.from_numpy(index),
                                  torch.from_numpy(uv), torch.from_numpy(rnd),
                                  torch.from_numpy(tpdf),
                                  torch.from_numpy(inv),
                                  active=torch.from_numpy(active))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _assert_reservoirs_equal(t1, j1)

    _, _, j2, t2 = _both_reservoirs(_random_reservoir(rng, n))
    j3, jsel = jres.combine_reservoirs(j1, j2, jnp.asarray(rnd),
                                       jnp.asarray(tpdf))
    t3, tsel = tres.combine_reservoirs(t1, t2, torch.from_numpy(rnd),
                                       torch.from_numpy(tpdf))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _assert_reservoirs_equal(t3, j3)
    _assert_reservoirs_equal(tres.finalize_resampling(t3, 1.0, 3.0),
                             jres.finalize_resampling(j3, 1.0, 3.0))

    vis = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    vis[::5] = 0.0  # invisible samples, discarded
    for discard in (False, True):
        _assert_reservoirs_equal(
            tres.store_visibility(t3, torch.from_numpy(vis), discard,
                                  active=torch.from_numpy(active)),
            jres.store_visibility(j3, jnp.asarray(vis), discard,
                                  active=jnp.asarray(active)))
    ok_t, vis_t = tres.get_reservoir_visibility(t3, 4, 3.0)
    ok_j, vis_j = jres.get_reservoir_visibility(j3, 4, 3.0)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    for fn in ("is_valid", "light_index", "sample_uv", "inv_pdf"):
        np.testing.assert_array_equal(
            getattr(tres, fn)(t3).numpy(),
            np.asarray(getattr(jres, fn)(j3)).astype(
                getattr(tres, fn)(t3).numpy().dtype), err_msg=fn)


def _helper_cases(rng, n=256):
    """(name, args) of each helper of restir/helpers.py, numpy inputs."""
    f32 = np.float32
    norms = rng.normal(size=(2, n, 3)).astype(f32)
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    depth = rng.uniform(1, 20, (2, n)).astype(f32)
    q = rng.uniform(-0.5, 2, (4, n)).astype(f32)
    px = rng.integers(0, 64, n).astype(np.int32)
    py = rng.integers(0, 64, n).astype(np.int32)
    idx = rng.integers(0, 1 << 16, n).astype(np.int32)
    weight = rng.uniform(0, 1, (20, 37)).astype(f32)
    weight[rng.uniform(size=weight.shape) < 0.3] = 0.0
    weight[3, 5] = 40.0  # a firefly the boiling filter kills
    return [
        ("compare_relative_difference", (depth[0], depth[1], 0.1)),
        ("is_valid_neighbor", (norms[0], norms[1], depth[0], depth[1], 0.5,
                               0.1)),
        ("m_factor", (q[0], q[1])),
        ("pairwise_mis_weight", tuple(q)),
        ("is_active_checkerboard_pixel", (px, py, True, 2)),
        ("activate_checkerboard_pixel", (px, py, False, 1)),
        ("activate_checkerboard_pixel", (px, py, True, 2)),
        ("pixel_pos_to_reservoir_pos", (px, py, 1)),
        ("reservoir_pos_to_pixel_pos", (px, py, 2)),
        ("apply_permutation_sampling", (px, py, np.uint32(13))),
        ("calculate_temporal_resampling_offset", (idx, 3)),
        ("boiling_filter_mask", (weight, 0.2)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_resampling_helpers_match_jax(case):
    """Each helper of restir/helpers.py (which the resampling passes of the
    later slices read) on the same inputs in both packages."""
    from raytracer2_tpu.restir import helpers as jh
    from raytracer2_tpu_torch.restir import helpers as th

    name, args = _helper_cases(np.random.default_rng(51))[case]

    def conv(a, to, scalar):
        if isinstance(a, np.ndarray):
            return to(a)
        return scalar(a) if isinstance(a, np.generic) else a

    want = getattr(jh, name)(*(conv(a, jnp.asarray, jnp.asarray)
                               for a in args))
    got = getattr(th, name)(*(conv(a, torch.from_numpy, np.generic.item)
                              for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=name)


def test_spatial_offsets_and_reservoir_pointers_match_jax():
    from raytracer2_tpu import params as jparams
    from raytracer2_tpu.lights import pdf_texture as jpdf
    from raytracer2_tpu.restir import helpers as jh
    from raytracer2_tpu_torch import params as tparams
    from raytracer2_tpu_torch.lights import pdf_texture as tpdf
    from raytracer2_tpu_torch.restir import helpers as th

    rng = np.random.default_rng(52)
    idx = rng.integers(0, 1 << 16, 256).astype(np.int32)
    got = th.calculate_spatial_resampling_offset(
        torch.from_numpy(idx), 32.0, tpdf.fill_neighbor_offsets(device=CPU),
        8191)
    want = jh.calculate_spatial_resampling_offset(
        jnp.asarray(idx), 32.0, jpdf.fill_neighbor_offsets(), 8191)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, h in ((W, H), (1920, 1080), (17, 5)):
        tp = tparams.calculate_reservoir_buffer_parameters(w, h)
        jp = jparams.calculate_reservoir_buffer_parameters(w, h)
        assert (tp.reservoir_block_row_pitch, tp.reservoir_array_pitch) == (
            jp.reservoir_block_row_pitch, jp.reservoir_array_pitch)
    rx = rng.integers(0, 1920, 256)
    ry = rng.integers(0, 1080, 256)
    np.testing.assert_array_equal(
        th.reservoir_position_to_pointer(tp, torch.from_numpy(rx),
                                         torch.from_numpy(ry), 1).numpy(),
        np.asarray(jh.reservoir_position_to_pointer(
            jp, jnp.asarray(rx), jnp.asarray(ry), 1)))
