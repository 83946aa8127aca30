"""DI temporal and spatial resampling and the DI boiling filter of the
PyTorch port against the JAX package: restir/di_resampling.py called
directly in all four bias-correction modes, the reservoir library's
masked resampling, the bridge's light-table reads, and whole DI frames
with GConst.enable_di_resampling on.

Both packages render the Cornell box at 16x16 from a camera off the box's
axis that moves a little every frame, in bench.py's DI validation config
(4 local-light + 1 BRDF candidates, final visibility, accumulation; GI
off), tracing through the same clusters with the same bundle shapes:
JAX's Pallas walks in interpret mode, the port's plain walks. Tolerances:
the integer fields of a reservoir (light data, uv, M, age, spatial
distance) and every RNG index bit for bit; the reservoirs' float fields
within 1e-5 (the library's own updates within 1e-6); displays within
rtol=atol=2e-3.
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
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render import gbuffer as jgb
from raytracer2_tpu.render.app_bridge import Tracers as JTracers
from raytracer2_tpu.render.app_bridge import make_bridge as j_make_bridge
from raytracer2_tpu.restir import di_resampling as jdr
from raytracer2_tpu.restir import di_reservoir as jres
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu.utils import rng as jrng
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.render import app_bridge as tab
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.render import gbuffer as tgb
from raytracer2_tpu_torch.restir import di_resampling as tdr
from raytracer2_tpu_torch.restir import di_reservoir as tres
from raytracer2_tpu_torch.utils import rng as trng

W = H = 16
CPU = torch.device("cpu")
FRAMES = 3
INT_FIELDS = ("light_data", "uv_data", "m", "packed_visibility",
              "spatial_distance", "age")
FLOAT_FIELDS = ("weight_sum", "target_pdf", "canonical_weight")


def _view(f: int):
    """The camera of frame f: off the box's axis, moving 0.05 a frame."""
    cam = default_camera(window_size=(W, H),
                         position=(0.13 + 0.05 * f, 0.07, -12),
                         direction=(0, 0, -1))
    return cam.planar_view_constants()


def resampling_gconst(n_lights, f: int, mode: int = 3, bias: int = 3,
                      boiling: bool = True, field: int = 0):
    """bench.py's DI validation config (bench.py:667-676) at frame f with
    DI resampling mode `mode`, temporal and spatial bias correction `bias`
    and the boiling filter, on checkerboard field `field`."""
    g = default_gconst(_view(f), n_lights, enable_restir_di=1,
                       enable_restir_gi=0, enable_accumulation=1,
                       correct_specular_accumulation=1,
                       enable_di_resampling=mode)
    di = g.restir_di
    return g.replace(
        frame=f, blend_factor=1.0 / (f + 1), prev_view=_view(max(f - 1, 0)),
        runtime_params=dataclasses.replace(g.runtime_params,
                                           active_checkerboard_field=field),
        restir_di=dataclasses.replace(
            di,
            initial_sampling_params=dataclasses.replace(
                di.initial_sampling_params,
                num_primary_local_light_samples=4),
            shading_params=dataclasses.replace(di.shading_params,
                                               enable_final_visibility=1),
            temporal_resampling_params=dataclasses.replace(
                di.temporal_resampling_params, temporal_bias_correction=bias,
                enable_boiling_filter=int(boiling),
                boiling_filter_strength=0.2),
            spatial_resampling_params=dataclasses.replace(
                di.spatial_resampling_params, spatial_bias_correction=bias)))


def _t_g(j_g):
    return convert.gconst_from_numpy(convert.to_numpy_tree(j_g))


# JAX's Pallas walk reports a hit for a ray whose t_max lies above its
# miss key (1.7e38) and that meets a candidate cluster but no triangle; the
# BRDF candidates pass FLT_MAX, and the port's walk reports the miss. JAX's
# walk gets t_max clamped below the key here (tests/test_torch_environment.py
# does the same), and its misses carry the caller's t_max.
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
def cornell(tmp_path_factory):
    p = tmp_path_factory.mktemp("dr") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(p))
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_renderer = tframe.create_renderer(t_scene, W, H)
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_pallas_tracers(t_renderer.tracers, j_scene))
    return dict(j_scene=j_scene, t_scene=t_scene, j_renderer=j_renderer,
                t_renderer=t_renderer, n=j_scene.num_emissive_triangles)


@pytest.fixture(scope="module")
def frames(cornell):
    """FRAMES resampling frames (mode 3, bias 3, the boiling filter) with
    a moving camera in both packages from fresh states, then one frame on
    checkerboard field 1: {name: (JAX state, JAX display, port state,
    port display)}."""
    out = {}
    j_state = jframe.init_frame_state(W, H)
    t_state = tframe.init_frame_state(W, H, device=CPU)
    for f in range(FRAMES):
        g = resampling_gconst(cornell["n"], f)
        j_state, j_img = jframe.render_frame(cornell["j_renderer"], g,
                                             j_state)
        t_state, t_img = tframe.render_frame(cornell["t_renderer"], _t_g(g),
                                             t_state)
        out[f] = (j_state, j_img, t_state, t_img)
    g = resampling_gconst(cornell["n"], 1, field=1)
    j_cb, j_img = jframe.render_frame(cornell["j_renderer"], g,
                                      jframe.init_frame_state(W, H, True))
    t_cb, t_img = tframe.render_frame(
        cornell["t_renderer"], _t_g(g),
        tframe.init_frame_state(W, H, True, device=CPU))
    out["checkerboard"] = (j_cb, j_img, t_cb, t_img)
    return out


def _assert_reservoir_matches(got, want, name, rtol=1e-5, atol=1e-5,
                              m_exact=True):
    """Integer fields bit for bit, float fields within rtol/atol. M is a
    float32 count, compared bit for bit, except where pairwise MIS scales
    it by m_factor's pow(x, 8) (m_exact=False): XLA's CPU pow and torch's
    round differently, so it is compared within 1e-6 there."""
    for f in INT_FIELDS:
        a = np.asarray(getattr(want, f)).astype(np.int64)
        b = getattr(got, f).numpy().astype(np.int64)
        if f == "m":
            if not m_exact:
                np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m),
                                           rtol=1e-6, err_msg=f"{name}: m")
                continue
            a = np.asarray(want.m).view(np.uint32)
            b = got.m.numpy().view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f"{name}: {f}")
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f"{name}: {f}")


@pytest.mark.parametrize("frame", [*range(FRAMES), "checkerboard"])
def test_resampling_frames_match_jax(frames, frame):
    """Displays within rtol=atol=2e-3; both DI slots (the shading slot and
    the temporal-input slot the shaded reservoir ping-pongs into) with
    their integer fields bit for bit and weights within 1e-5."""
    j_state, j_img, t_state, t_img = frames[frame]
    got, want = t_img.numpy(), np.asarray(j_img)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert got.max() > 0.05  # lit, not black
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    for slot in (0, 1):
        _assert_reservoir_matches(t_state.di_reservoirs[slot],
                                  j_state.di_reservoirs[slot],
                                  f"slot {slot}")
    # with resampling on, both slots hold this frame's shaded reservoir
    assert torch.equal(t_state.di_reservoirs[0].light_data,
                       t_state.di_reservoirs[1].light_data)


def test_temporal_history_grows(frames):
    """The temporal stage carries M across frames (capped by
    max_history_length * M of the new sample)."""
    m0 = frames[0][2].di_reservoirs[1].m.max()
    m2 = frames[FRAMES - 1][2].di_reservoirs[1].m.max()
    assert m2 > m0 >= 1.0


# ---------------------------------------------------------------------------
# The stages called directly, over frame 1's G-buffers and reservoirs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage_inputs(cornell, frames):
    """Both packages' bridges over frame 2's G-buffer and frame 1's
    (its previous), frame 2's shaded reservoirs as the current sample and
    frame 1's as the previous ones (carried across with convert.py), and
    frame 2's motion, for a given GConst."""
    j_prev_state, j_state = frames[1][0], frames[2][0]
    jr, tr = cornell["j_renderer"], cornell["t_renderer"]
    t_gbuf, t_prev = (convert.gbuffer_from_numpy(convert.to_numpy_tree(gb),
                                                 device=CPU)
                      for gb in (j_state.gbuffer, j_prev_state.gbuffer))
    t_cur = convert.di_reservoir_from_numpy(
        convert.to_numpy_tree(j_state.di_reservoirs[0]), device=CPU)
    t_slots = convert.di_slots_from_numpy(
        [convert.to_numpy_tree(r) for r in j_prev_state.di_reservoirs],
        device=CPU)

    def make(g):
        t_g = _t_g(g)
        jl, tl = jr.scene_lights, tr.scene_lights
        j_bridge = j_make_bridge(
            cornell["j_scene"], jr.tracers, j_state.gbuffer,
            j_prev_state.gbuffer, g, jl.lights, jl.geometry_to_light,
            jl.local_pdf_mips, jl.env_pdf_mips, jr.neighbor_offsets, W, H)
        t_bridge = tab.make_bridge(
            cornell["t_scene"], tr.tracers, t_gbuf, t_prev, t_g, tl.lights,
            tl.geometry_to_light, tl.local_pdf_mips, tl.env_pdf_mips,
            tr.neighbor_offsets, W, H)
        return dict(
            j=(j_bridge, jgb.surface_from_gbuffer_grid(j_state.gbuffer,
                                                       g.view),
               j_state.di_reservoirs[0], j_prev_state.di_reservoirs[1],
               j_state.motion),
            t=(t_bridge, tgb.surface_from_gbuffer_grid(t_gbuf, t_g.view),
               t_cur, t_slots[1],
               torch.from_numpy(np.array(j_state.motion))))
    return make


def _rngs(seed):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    j = jrng.init_random_sampler(jnp.asarray(xs, jnp.uint32),
                                 jnp.asarray(ys, jnp.uint32), seed)
    px, py = (torch.from_numpy(a.astype(np.int32)) for a in (xs, ys))
    return (jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32), j), \
        (px, py, trng.init_random_sampler(px, py, seed))


@pytest.mark.parametrize("bias", range(4))
def test_temporal_resampling_matches_jax(cornell, stage_inputs, bias):
    """di_temporal_resampling in bias mode `bias`: reservoir integer
    fields and RNG indices bit for bit, weights within 1e-5."""
    g = resampling_gconst(cornell["n"], 2, bias=bias)
    ins = stage_inputs(g)
    (jpx, jpy, j_rng), (tpx, tpy, t_rng) = _rngs(2 + 13)
    spec = dict(bias_correction_mode=bias, max_history_length=5)
    jb, js, jcur, jprev, jmotion = ins["j"]
    tb, ts, tcur, tprev, tmotion = ins["t"]
    want, j_rng = jdr.di_temporal_resampling(
        jpx, jpy, js, jcur, j_rng, jdr.DITemporalSpec(**spec), jmotion, 0,
        jprev, jb)
    got, t_rng = tdr.di_temporal_resampling(
        tpx, tpy, ts, tcur, t_rng, tdr.DITemporalSpec(**spec), tmotion, 0,
        tprev, tb)
    _assert_reservoir_matches(got, want, f"temporal bias {bias}")
    np.testing.assert_array_equal(t_rng.index.numpy(),
                                  np.asarray(j_rng.index))
    assert (got.m > tcur.m).any()  # some lane merged its history


@pytest.mark.parametrize("bias", range(4))
def test_spatial_resampling_matches_jax(cornell, stage_inputs, bias):
    """di_spatial_resampling in bias mode `bias` (2 is the pairwise-MIS
    variant), with the disocclusion boost on for lanes of short history:
    reservoir integer fields and RNG indices bit for bit (M within 1e-6
    under pairwise MIS), weights within 1e-5."""
    g = resampling_gconst(cornell["n"], 2, bias=bias)
    ins = stage_inputs(g)
    (jpx, jpy, j_rng), (tpx, tpy, t_rng) = _rngs(2 + 13)
    spec = dict(bias_correction_mode=bias, num_samples=2,
                num_disocclusion_boost_samples=3, target_history_length=3,
                sampling_radius=6.0)
    jb, js, jcur, jprev, _ = ins["j"]
    tb, ts, tcur, tprev, _ = ins["t"]
    want, j_rng = jdr.di_spatial_resampling(
        jpx, jpy, js, jcur, j_rng, jdr.DISpatialSpec(**spec), jprev, jb)
    got, t_rng = tdr.di_spatial_resampling(
        tpx, tpy, ts, tcur, t_rng, tdr.DISpatialSpec(**spec), tprev, tb)
    _assert_reservoir_matches(got, want, f"spatial bias {bias}",
                              m_exact=bias != 2)
    np.testing.assert_array_equal(t_rng.index.numpy(),
                                  np.asarray(j_rng.index))


def test_boiling_filter_matches_jax(frames):
    """di_boiling_filter on a frame's reservoirs with a firefly: the kill
    mask bit for bit, the filtered reservoirs equal."""
    j_res = frames[1][0].di_reservoirs[0]
    ws = np.array(j_res.weight_sum)
    ws[5, 7] = 1e4 * max(float(ws.max()), 1.0)  # a firefly
    j_res = j_res._replace(weight_sum=jnp.asarray(ws))
    t_res = convert.di_reservoir_from_numpy(convert.to_numpy_tree(j_res),
                                            device=CPU)
    want = jdr.di_boiling_filter(j_res, 0.2)
    got = tdr.di_boiling_filter(t_res, 0.2)
    killed = got.light_data.numpy() == 0
    np.testing.assert_array_equal(killed, np.asarray(want.light_data) == 0)
    assert killed[5, 7] and not killed.all()
    _assert_reservoir_matches(got, want, "boiling", rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The reservoir library and the bridge's light reads
# ---------------------------------------------------------------------------

def _random_reservoir(rng, n):
    valid = rng.uniform(size=n) < 0.7
    return dict(
        light_data=np.where(valid, rng.integers(0, 50, n) | 0x80000000, 0),
        uv_data=rng.integers(0, 1 << 32, n),
        weight_sum=rng.uniform(0, 3, n).astype(np.float32),
        target_pdf=rng.uniform(0, 2, n).astype(np.float32),
        m=rng.integers(1, 5, n).astype(np.float32),
        packed_visibility=rng.integers(0, 1 << 18, n),
        spatial_distance=rng.integers(-3, 4, (n, 2)).astype(np.int32),
        age=rng.integers(0, 6, n),
        canonical_weight=rng.uniform(0, 1, n).astype(np.float32))


def _both(fields):
    j = jres.DIReservoir(**{
        k: jnp.asarray(v.astype(np.uint32) if v.dtype == np.int64 else v)
        for k, v in fields.items()})
    return j, convert.di_reservoir_from_numpy(fields, device=CPU)


@pytest.mark.parametrize("fn", ["internal_simple_resample",
                                "combine_reservoirs", "_where_res"])
def test_masked_resampling_matches_jax(fn):
    """The masked reservoir updates the resampling stages stream through:
    integer fields and the selection mask bit for bit, floats within
    1e-6."""
    rng = np.random.default_rng(60)
    n = 512
    j_a, t_a = _both(_random_reservoir(rng, n))
    j_b, t_b = _both(_random_reservoir(rng, n))
    rnd = rng.uniform(size=n).astype(np.float32)
    tpdf = rng.uniform(0, 2, n).astype(np.float32)
    norm = rng.uniform(0, 4, n).astype(np.float32)
    m = rng.uniform(0, 3, n).astype(np.float32)
    active = rng.uniform(size=n) < 0.6
    j_args = [jnp.asarray(x) for x in (rnd, tpdf, norm, m, active)]
    t_args = [torch.from_numpy(x) for x in (rnd, tpdf, norm, m, active)]
    if fn == "_where_res":
        want = jres._where_res(j_args[4], j_a, j_b)
        got = tres._where_res(t_args[4], t_a, t_b)
        _assert_reservoir_matches(got, want, fn, rtol=0, atol=0)
        return
    if fn == "combine_reservoirs":
        want, jsel = jres.combine_reservoirs(j_a, j_b, j_args[0], j_args[1],
                                             active=j_args[4])
        got, tsel = tres.combine_reservoirs(t_a, t_b, t_args[0], t_args[1],
                                            active=t_args[4])
    else:
        want, jsel = jres.internal_simple_resample(j_a, j_b, *j_args[:4],
                                                   active=j_args[4])
        got, tsel = tres.internal_simple_resample(t_a, t_b, *t_args[:4],
                                                  active=t_args[4])
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert 0 < int(tsel.sum()) < int(active.sum())
    _assert_reservoir_matches(got, want, fn, rtol=1e-6, atol=1e-6)


def test_load_light_info_reads_jax_records(cornell, frames):
    """RAB_LoadLightInfo on out-of-range indices reads the record JAX
    reads: the invalid light index 0x7FFFFFFF and the table size read the
    last light, -1 (0xFFFFFFFF as a uint32 word) the first; a valid
    reservoir's index reads its own light."""
    j_state = frames[0][0]
    g = resampling_gconst(cornell["n"], 0)
    jr, tr = cornell["j_renderer"], cornell["t_renderer"]
    jl, tl = jr.scene_lights, tr.scene_lights
    n = int(tl.lights.center.shape[0])
    t_gbuf = convert.gbuffer_from_numpy(convert.to_numpy_tree(
        j_state.gbuffer), device=CPU)
    j_bridge = j_make_bridge(
        cornell["j_scene"], jr.tracers, j_state.gbuffer, j_state.gbuffer, g,
        jl.lights, jl.geometry_to_light, jl.local_pdf_mips, jl.env_pdf_mips,
        jr.neighbor_offsets, W, H)
    t_bridge = tab.make_bridge(
        cornell["t_scene"], tr.tracers, t_gbuf, t_gbuf, _t_g(g), tl.lights,
        tl.geometry_to_light, tl.local_pdf_mips, tl.env_pdf_mips,
        tr.neighbor_offsets, W, H)
    index = np.array([0x7FFFFFFF, n, n + 7, 0xFFFFFFFF, 0, n - 1, 1],
                     np.int64)
    want = j_bridge.load_light_info(jnp.asarray(index.astype(np.uint32)),
                                    False)
    got = t_bridge.load_light_info(torch.from_numpy(index), False)
    for f in want._fields:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(getattr(got, f).numpy().dtype),
            err_msg=f)
    np.testing.assert_array_equal(got.center[0].numpy(),
                                  tl.lights.center[n - 1].numpy())
    np.testing.assert_array_equal(got.center[3].numpy(),
                                  tl.lights.center[0].numpy())
