"""Checkerboard rendering and the per-pass frame prefixes of the PyTorch
port against the JAX package: init_frame_state(checkerboard=True),
surface_from_gbuffer_grid on one field, whole frames that alternate the
fields (the DI pass and the five GI passes on the active half of the
pixels, the lighting images gathered before them and scattered back
after), render_frame(stop_after=...) for every FRAME_PASSES prefix, and
utils/profiler.py::count_frame_rays.

The frames render the Cornell box at 32x16 from a camera off the box's
axis in three configurations: the flagship one (bench.py's pipeline
frame: default GConst plus DI, GI temporal and spatial off), the goldens'
one (GI temporal and spatial on) and bench.py's DI validation config (GI
off, final visibility: its [16, 16] half-grid visibility batch takes the
8x16 screen-tile layout), fields 1, 2, 1 as bench.py's at_frame
alternates them. Both packages trace through the same clusters with the
same bundle shapes: JAX's Pallas walks in interpret mode, the port's plain
walks and plain cull passes. Display and lighting images agree within
rtol=atol=2e-3, the DI and GI reservoirs within 1e-5 and the secondary
G-buffer's integer planes bit for bit.
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
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu.utils import profiler as jprof
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.render import di_passes as tdi
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.render import gbuffer as tgb
from raytracer2_tpu_torch.render import gi_passes as tgi
from raytracer2_tpu_torch.utils import profiler as tprof

W, H = 32, 16
CPU = torch.device("cpu")
FRAMES = 3
CONFIGS = {
    # bench.py:266-272: the default GConst plus DI
    "flagship": dict(enable_restir_di=1),
    # tests/test_goldens.py:39-43
    "goldens": dict(enable_restir_di=1, enable_restir_gi=1,
                    enable_temporal_resampling=1,
                    enable_spatial_resampling=1),
    # bench.py:667-676 ("restir-di 4NEE+1BRDF finalvis"), below
    "di": dict(enable_restir_di=1, enable_restir_gi=0, enable_accumulation=1,
               correct_specular_accumulation=1),
}
GI_CONFIGS = ("flagship", "goldens")


def _config(view, lights, name):
    g = default_gconst(view, lights, **CONFIGS[name])
    if name == "di":  # 4 local-light + 1 BRDF candidates, final visibility
        di = g.restir_di
        g = g.replace(restir_di=dataclasses.replace(
            di, initial_sampling_params=dataclasses.replace(
                di.initial_sampling_params,
                num_primary_local_light_samples=4),
            shading_params=dataclasses.replace(di.shading_params,
                                               enable_final_visibility=1)))
    return g


def _field(g, field: int):
    return g.replace(runtime_params=dataclasses.replace(
        g.runtime_params, active_checkerboard_field=field))


def _at_frame(g, f: int):
    """bench.py's at_frame (bench.py:275-281): frame f on field 1 + (f & 1);
    an accumulating config blends 1/(f+1), as bench.py's DI loop."""
    if g.enable_accumulation:
        g = g.replace(blend_factor=1.0 / (f + 1))
    return _field(g.replace(frame=f), 1 + (f & 1))


def _t_g(j_g):
    return convert.gconst_from_numpy(convert.to_numpy_tree(j_g))


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
    p = tmp_path_factory.mktemp("cb") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(p))
    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    view = cam.planar_view_constants()
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_renderer = tframe.create_renderer(t_scene, W, H)
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_pallas_tracers(t_renderer.tracers, j_scene))
    gconsts = {name: _config(view, j_scene.num_emissive_triangles, name)
               for name in CONFIGS}
    return dict(j_renderer=j_renderer, t_renderer=t_renderer,
                gconsts=gconsts)


@pytest.fixture(scope="module")
def frames(cornell):
    """FRAMES checkerboard frames of render_frame per configuration in
    both packages from fresh states, fields 1, 2, 1: {config: [(JAX state,
    JAX display, port state, port display)]}."""
    out = {}
    for name, j_g in cornell["gconsts"].items():
        j_state = jframe.init_frame_state(W, H, checkerboard=True)
        t_state = tframe.init_frame_state(W, H, checkerboard=True,
                                          device=CPU)
        out[name] = []
        for f in range(FRAMES):
            g = _at_frame(j_g, f)
            j_state, j_img = jframe.render_frame(cornell["j_renderer"], g,
                                                 j_state)
            t_state, t_img = tframe.render_frame(cornell["t_renderer"],
                                                 _t_g(g), t_state)
            out[name].append((j_state, j_img, t_state, t_img))
    return out


def _close(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and (got >= 0).all(), name
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=name)


def _differences(got, want, tol=1e-5) -> int:
    """Values of a NamedTuple of arrays that differ beyond rtol=atol=tol."""
    n = 0
    for f in want._fields:
        a = np.asarray(getattr(want, f)).astype(np.float64)
        b = getattr(got, f).numpy().astype(np.float64)
        assert a.shape == b.shape, f
        n += int((~np.isclose(b, a, rtol=tol, atol=tol)).sum())
    return n


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("checkerboard", [False, True])
def test_init_frame_state_shapes_match_jax(checkerboard):
    """Under checkerboard the reservoirs and the secondary G-buffer are
    [H, W//2]; the G-buffers, motion and lighting images stay [H, W]."""
    w, h = 12, 6
    got = tframe.init_frame_state(w, h, checkerboard, device=CPU)
    want = jframe.init_frame_state(w, h, checkerboard)
    assert ([tuple(np.shape(x)) for x in _leaves(want)]
            == [tuple(x.shape) for x in _leaves(got)])
    w_res = w // 2 if checkerboard else w
    assert got.gi_reservoirs[1].m.shape == (h, w_res)
    assert got.di_reservoirs[0].weight_sum.shape == (h, w_res)
    assert got.secondary.world_pos.shape == (h, w_res, 3)
    assert got.diffuse_lighting.shape == got.motion.shape == (h, w, 3)


@pytest.mark.parametrize("field", [1, 2])
def test_surface_from_gbuffer_grid_fields_match_jax(cornell, frames, field):
    """The same packed planes (a JAX frame's G-buffer, carried across)
    give the same surfaces over the active field's [H, W//2] grid."""
    j_state = frames["flagship"][-1][0]
    view = cornell["gconsts"]["flagship"].view
    jgbuf = j_state.gbuffer
    tgbuf = convert.gbuffer_from_numpy(convert.to_numpy_tree(jgbuf),
                                       device=CPU)
    got = tgb.surface_from_gbuffer_grid(tgbuf, _t_g(
        cornell["gconsts"]["flagship"]).view, field)
    want = jgb.surface_from_gbuffer_grid(jgbuf, view, field=field)
    assert got.world_pos.shape == (H, W // 2, 3)
    assert bool(got.valid.any())
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


SECONDARY_INT_PLANES = ("normal", "throughput", "diffuse_albedo",
                        "specular_and_roughness")


@pytest.mark.parametrize("config,frame",
                         [(c, f) for c in GI_CONFIGS for f in range(FRAMES)])
def test_checkerboard_frames_match_jax(frames, config, frame):
    j_state, j_img, t_state, t_img = frames[config][frame]
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05  # lit, not black
    sec = t_state.secondary
    assert sec.world_pos.shape == (H, W // 2, 3)
    for f in SECONDARY_INT_PLANES:
        np.testing.assert_array_equal(
            getattr(sec, f).numpy(),
            np.asarray(getattr(j_state.secondary, f)).astype(np.int64),
            err_msg=f)
    assert (sec.throughput[..., 0] != 0).float().mean() > 0.5
    # float planes: an escaped bounce stores its position 1,000 units out
    for f in ("world_pos", "emission", "pdf"):
        np.testing.assert_allclose(
            getattr(sec, f).numpy(), np.asarray(getattr(j_state.secondary, f)),
            rtol=1e-4, atol=1e-5, err_msg=f)
    for slot in range(2):
        n = _differences(t_state.gi_reservoirs[slot],
                         j_state.gi_reservoirs[slot])
        assert n == 0, f"slot {slot}: {n} GI reservoir values differ"
    assert (t_state.gi_reservoirs[0].m > 0).float().mean() > 0.3


@pytest.mark.parametrize("frame", range(FRAMES))
def test_checkerboard_di_frames_match_jax(cornell, frames, frame):
    """The DI validation config: its initial and final visibility rays
    (one [16, 16] batch of the active field in 8x16 screen tiles, the
    any-hit walk) and its DI reservoirs, on alternating fields."""
    j_state, j_img, t_state, t_img = frames["di"][frame]
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05
    assert t_state.di_reservoirs[0].weight_sum.shape == (H, W // 2)
    for slot in range(2):
        n = _differences(t_state.di_reservoirs[slot],
                         j_state.di_reservoirs[slot])
        assert n == 0, f"slot {slot}: {n} DI reservoir values differ"


def test_inactive_field_keeps_last_frames_lighting(frames):
    """A frame shades only its field: the other half of the lighting
    images is the previous frame's, bit for bit."""
    (_, _, s0, _), (_, _, s1, _) = frames["flagship"][:2]
    # field 2 shades the pixels with x + y even
    keep = np.indices((H, W)).sum(axis=0) % 2 == 1
    for f in ("diffuse_lighting", "specular_lighting"):
        a, b = getattr(s1, f).numpy(), getattr(s0, f).numpy()
        np.testing.assert_array_equal(a[keep], b[keep])
        assert not np.array_equal(a[~keep], b[~keep])


def test_checkerboard_row_bands_change_nothing(cornell, frames,
                                               monkeypatch):
    """Above _BAND_THRESHOLD lanes the DI, BRDF-ray, secondary and final
    passes run in row bands of the active field's [H, W//2] grid; the
    bands change no value but the secondary G-buffer's float planes,
    which may move by an ulp here: torch's CPU pow rounds the lanes its
    vector loop takes and the tail it leaves apart, so a lane can round
    otherwise in a band of another width."""
    tr = cornell["t_renderer"]
    g = _t_g(_at_frame(cornell["gconsts"]["goldens"], 1))
    state = frames["goldens"][0][2]
    s1, whole = tframe.render_frame(tr, g, state)
    half = W // 2
    monkeypatch.setattr(tgi, "_BAND_THRESHOLD", 2 * half * 3)  # 3 rows
    monkeypatch.setattr(tdi, "_BAND_THRESHOLD", 2 * half * 3)
    b1, banded = tframe.render_frame(tr, g, state)
    np.testing.assert_array_equal(banded.numpy(), whole.numpy())
    floats = {"world_pos", "emission", "pdf"}
    for name, a, b in zip(b1.secondary._fields, b1.secondary, s1.secondary):
        if name in floats:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    for a, b in zip(_leaves(b1._replace(secondary=())),
                    _leaves(s1._replace(secondary=()))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _assert_matches(got, want, name):
    """A prefix's output against JAX's: integer planes bit for bit, float
    images within rtol=atol=2e-3, GI reservoir values within 1e-5."""
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__, name
        if type(want).__name__ == "GIReservoir":
            assert _differences(got, want) == 0, name
            return
        fields = getattr(want, "_fields", range(len(want)))
        for f, g, w in zip(fields, got, want):
            _assert_matches(g, w, f"{name}.{f}")
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape, name
    if w.dtype == np.uint32:
        np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=name)
    elif name.endswith(("world_pos", "emission", "pdf")):
        # the secondary G-buffer's float planes (an escaped bounce sits
        # 1,000 units out)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("stop", tframe.FRAME_PASSES)
def test_stop_after_prefixes_match_jax(cornell, frames, stop):
    """Each prefix of a goldens-config checkerboard frame (field 2, on the
    state after the first frame) returns the input state untouched and the
    same intermediate tuple as JAX's; "post" is the whole frame."""
    assert tframe.FRAME_PASSES == jframe.FRAME_PASSES
    g = _at_frame(cornell["gconsts"]["goldens"], 1)
    j_state, _, t_state, _ = frames["goldens"][0]
    j_s, j_out = jframe.render_frame(cornell["j_renderer"], g, j_state,
                                     stop_after=stop)
    t_s, t_out = tframe.render_frame(cornell["t_renderer"], _t_g(g),
                                     t_state, stop_after=stop)
    if stop != "post":
        assert t_s is t_state and j_s is j_state
    _assert_matches(t_out, j_out, stop)


def test_render_frame_rejects_bad_arguments(cornell):
    """An unknown pass name, and a state whose reservoirs do not match
    the field (full width on a checkerboard field, half on the full
    grid)."""
    g = _t_g(cornell["gconsts"]["flagship"])
    tr = cornell["t_renderer"]
    state = tframe.init_frame_state(W, H, device=CPU)
    with pytest.raises(ValueError, match="stop_after"):
        tframe.render_frame(tr, g, state, stop_after="shade")
    with pytest.raises(ValueError, match="checkerboard=True"):
        tframe.render_frame(tr, _field(g, 1), state)
    with pytest.raises(ValueError, match="checkerboard=False"):
        tframe.render_frame(tr, g, tframe.init_frame_state(
            W, H, checkerboard=True, device=CPU))


@pytest.mark.parametrize("field", [0, 1])
def test_render_frame_leaves_the_input_state_unchanged(cornell, frames,
                                                       field):
    tr = cornell["t_renderer"]
    state = frames["goldens"][1][2] if field else tframe.init_frame_state(
        W, H, device=CPU)
    before = [x.clone() for x in _leaves(state)]
    g = _field(cornell["gconsts"]["goldens"].replace(frame=5), field)
    new, _ = tframe.render_frame(tr, _t_g(g), state)
    for a, b in zip(_leaves(state), before):
        assert torch.equal(a, b)
    assert not torch.equal(new.diffuse_lighting, state.diffuse_lighting)


def _ray_configs(view, lights):
    g = default_gconst(view, lights, enable_restir_di=1)
    di = g.restir_di
    vis = g.replace(enable_restir_gi=0, restir_di=dataclasses.replace(
        di, initial_sampling_params=dataclasses.replace(
            di.initial_sampling_params, enable_initial_visibility=1),
        shading_params=dataclasses.replace(di.shading_params,
                                           enable_final_visibility=1)))
    gi = g.restir_gi
    gi_bias3 = g.replace(
        enable_temporal_resampling=1, restir_gi=dataclasses.replace(
            gi, temporal_resampling_params=dataclasses.replace(
                gi.temporal_resampling_params,
                temporal_bias_correction_mode=3),
            final_shading_params=dataclasses.replace(
                gi.final_shading_params, enable_final_visibility=1)))
    return {"flagship": g, "di_visibility": vis, "gi_bias3": gi_bias3,
            "reference": g.replace(refrence_mode=1)}


@pytest.mark.parametrize("field", [0, 1, 2])
@pytest.mark.parametrize("config", ["flagship", "di_visibility", "gi_bias3",
                                    "reference"])
def test_count_frame_rays_matches_jax(cornell, config, field):
    j_g = cornell["gconsts"]["flagship"]
    g = _field(_ray_configs(j_g.view, 2)[config], field)
    for w, h in ((W, H), (1920, 1080)):
        got = tprof.count_frame_rays(_t_g(g), w, h)
        assert got == jprof.count_frame_rays(g, w, h)
    if config == "flagship":  # G-buffer, DI BRDF candidate, 2 GI bounces
        assert got == 1920 * 1080 * (1 + 3 / (2 if field else 1))


def test_pass_timer_counts_on_the_cpu():
    """PassTimer on a CPU device synchronises nothing and keeps one sample
    per timed run of each pass."""
    timer = tprof.PassTimer(CPU)
    for _ in range(3):
        with timer.time("frame"):
            torch.ones(4).sum()
    with timer.time("post"):
        pass
    assert len(timer.samples["frame"]) == 3
    assert len(timer.samples["post"]) == 1
    assert all(x >= 0.0 for x in timer.samples["frame"])
