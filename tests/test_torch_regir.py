"""ReGIR of the PyTorch port against the JAX package: the onion layout's
tables, the grid and onion cell indexing both ways, the jitter scale, the
light weight for a volume, the grid build (presample_regir_grid), the cell
draw and one DI frame with local-light sampling mode 2 (the ReGIR grid).

The lights are the Cornell box's, carried across with convert.py; the
grids are cut to 4x4x4 cells of 8 lights (the onion layout to 4 lights a
cell) so the CPU build stays small. Tolerances: cell indices, onion
tables, light indices, weight bits where stated and RNG indices bit for
bit; cell centres, radii, jitter scales and weights within 1e-6 (relative
to the value, with 1e-6 absolute near zero); the frame's display within
rtol=atol=2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.lights.prepare import prepare_lights as j_prepare_lights
from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.ops import cluster as jcluster
from raytracer2_tpu.ops import pallas_traverse as ptm
from raytracer2_tpu.params import LightBufferRegion as JRegion
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render.app_bridge import Tracers as JTracers
from raytracer2_tpu.restir import regir as jregir
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu.utils import rng as jrng
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.params import LightBufferRegion as TRegion
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.restir import regir as tregir
from raytracer2_tpu_torch.utils import rng as trng

W = H = 16
CPU = torch.device("cpu")
LAYOUTS = ("grid", "onion")
T_MAX_BELOW_MISS_KEY = 1e38  # tests/test_torch_di_resampling.py says why


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    p = tmp_path_factory.mktemp("regir") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(p))
    j_lights = j_prepare_lights(j_scene)
    t_lights = convert.scene_lights_from_numpy(
        convert.to_numpy_tree(j_lights), device=CPU)
    lo = j_scene.host_tri_v0.min(axis=0)
    hi = j_scene.host_tri_v0.max(axis=0)
    center = tuple(float(x) for x in 0.5 * (lo + hi))
    cell = float(np.max(hi - lo)) / 4
    params = {
        "grid": jregir.ReGIRGridParameters(center=center, cell_size=cell,
                                           cells=(4, 4, 4),
                                           lights_per_cell=8),
        "onion": jregir.ReGIRGridParameters(
            center=center, cell_size=cell / 2, lights_per_cell=4,
            onion=jregir.build_onion_layout(cell / 2)),
    }
    return dict(j_scene=j_scene, j_lights=j_lights, t_lights=t_lights,
                params=params, lo=lo, hi=hi)


def _t_params(j_params):
    return convert.regir_params_from_numpy(convert.to_numpy_tree(j_params))


def _close(got, want, name, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


def _positions(cornell, n=4096, seed=70):
    """Positions over twice the scene's box (some outside every cell)."""
    lo, hi = cornell["lo"], cornell["hi"]
    mid, half = 0.5 * (lo + hi), (hi - lo)
    rng = np.random.default_rng(seed)
    return (mid + rng.uniform(-1, 1, (n, 3)) * half).astype(np.float32)


def test_onion_layout_matches_jax():
    """build_onion_layout's tables, field for field."""
    for args in ((1.0,), (0.37, 3, 6, 1.3, 1.8)):
        want = jregir.build_onion_layout(*args)
        got = tregir.build_onion_layout(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cell_indices_match_jax(cornell, layout):
    """world_pos_to_cell_index on positions in and around the scene, bit
    for bit; and the jitter scale within 1e-6."""
    jp = cornell["params"][layout]
    tp = _t_params(jp)
    pos = _positions(cornell)
    want = np.asarray(jregir.world_pos_to_cell_index(jp, jnp.asarray(pos)))
    got = tregir.world_pos_to_cell_index(tp, torch.from_numpy(pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 16
    if layout == "grid":  # the onion's outer shells cover every position
        assert (want < 0).any()
    _close(torch.as_tensor(tregir.get_jitter_scale(tp,
                                                   torch.from_numpy(pos))),
           jregir.get_jitter_scale(jp, jnp.asarray(pos)), "jitter")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cell_centres_match_jax(cornell, layout):
    """cell_index_to_world_pos over every cell (and -1 and one past the
    last): validity bit for bit, centres and radii within 1e-6; a grid
    cell's centre maps back to that cell."""
    jp = cornell["params"][layout]
    tp = _t_params(jp)
    idx = np.arange(-1, jp.num_cells + 1, dtype=np.int32)
    jv, jpos, jrad = jregir.cell_index_to_world_pos(jp, jnp.asarray(idx))
    tv, tpos, trad = tregir.cell_index_to_world_pos(tp, torch.from_numpy(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tpos, jpos, "centre")
    _close(trad, jrad, "radius")
    if layout == "grid":
        back = tregir.world_pos_to_cell_index(tp, tpos[tv])
        np.testing.assert_array_equal(back.numpy(), idx[tv.numpy()])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_presample_regir_grid_matches_jax(cornell, layout):
    """The grid build: every slot's light index bit for bit, its weight
    within 1e-6; the cells the lights reach hold lights."""
    jp = cornell["params"][layout]
    n = cornell["j_lights"].num_local_lights
    want = np.asarray(jax.jit(jregir.presample_regir_grid,
                              static_argnums=(0, 2, 3))(
        7, cornell["j_lights"].lights, JRegion(0, n), jp)).astype(np.int64)
    got = tregir.presample_regir_grid(
        7, cornell["t_lights"].lights, TRegion(0, n), _t_params(jp))
    assert got.shape == (jp.num_cells * jp.lights_per_cell, 2)
    np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
    _close(got[:, 1].to(torch.int32).view(torch.float32),
           want[:, 1].astype(np.uint32).view(np.float32), "weight")
    assert (got[:, 1] != 0).float().mean() > 0.2


def test_light_weight_for_volume_matches_jax(cornell):
    """RAB_GetLightTargetPdfForVolume of every light against cells of
    several sizes, within 1e-6."""
    lights_j, lights_t = cornell["j_lights"].lights, cornell["t_lights"].lights
    n = lights_t.center.shape[0]
    pos = _positions(cornell, 512)
    radius = np.random.default_rng(71).uniform(0.1, 3.0, 512).astype(
        np.float32)
    idx = np.arange(512) % n
    want = jregir.get_light_weight_for_volume(
        type(lights_j)(*(leaf[jnp.asarray(idx)] for leaf in lights_j)),
        jnp.asarray(pos), jnp.asarray(radius))
    got = tregir.get_light_weight_for_volume(
        type(lights_t)(*(leaf[torch.from_numpy(idx)] for leaf in lights_t)),
        torch.from_numpy(pos), torch.from_numpy(radius))
    _close(got, want, "weight")
    assert (np.asarray(want) > 0).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_select_light_from_regir_cell_matches_jax(cornell, layout):
    """The cell draw: light index, inverse pdf bits, validity and the RNG
    index bit for bit, cells -1 (none) included."""
    jp = cornell["params"][layout]
    tp = _t_params(jp)
    n = cornell["j_lights"].num_local_lights
    j_buf = jax.jit(jregir.presample_regir_grid, static_argnums=(0, 2, 3))(
        3, cornell["j_lights"].lights, JRegion(0, n), jp)
    t_buf = convert.tensor_from_numpy(np.asarray(j_buf), device=CPU)
    rng = np.random.default_rng(72)
    cells = rng.integers(-1, jp.num_cells, 2048).astype(np.int32)
    px, py = (rng.integers(0, 64, 2048).astype(np.uint32) for _ in range(2))
    j_rng = jrng.init_random_sampler(jnp.asarray(px), jnp.asarray(py), 9)
    t_rng = trng.init_random_sampler(torch.from_numpy(px.astype(np.int64)),
                                     torch.from_numpy(py.astype(np.int64)), 9)
    jli, jinv, jvalid, j_rng = jregir.select_light_from_regir_cell(
        j_rng, j_buf, jnp.asarray(cells), jp)
    tli, tinv, tvalid, t_rng = tregir.select_light_from_regir_cell(
        t_rng, t_buf, torch.from_numpy(cells), tp)
    np.testing.assert_array_equal(tli.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(tinv.numpy().view(np.uint32),
                                  np.asarray(jinv).view(np.uint32))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(t_rng.index.numpy(),
                                  np.asarray(j_rng.index))
    assert tvalid.any() and not tvalid.all()


def test_make_regir_params_matches_jax(cornell, monkeypatch):
    """The grid create_renderer(regir=True) sizes to the scene box, and the
    renderer holds that grid's buffer (built here at 2x2x2 cells)."""
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(
        cornell["j_scene"]), device=CPU)
    assert tframe.make_regir_params(t_scene) == _t_params(
        jframe.make_regir_params(cornell["j_scene"]))
    small = tframe.make_regir_params(t_scene, (2, 2, 2), 4)
    monkeypatch.setattr(tframe, "make_regir_params", lambda scene: small)
    r = tframe.create_renderer(t_scene, W, H, backend="brute",
                               presample=False, regir=True)
    assert r.regir_params == small
    assert r.regir_ris_buffer.shape == (8 * 4, 2)
    # mode 2 samples the grid even with the RIS tiles off
    g = convert.gconst_from_numpy(convert.to_numpy_tree(default_gconst(
        default_camera(window_size=(W, H)).planar_view_constants(),
        cornell["j_scene"].num_emissive_triangles)))
    di = g.restir_di
    g2 = g.replace(restir_di=dataclasses.replace(
        di, initial_sampling_params=dataclasses.replace(
            di.initial_sampling_params, local_light_sampling_mode=2)))
    assert r.light_ctx(g2).enable_presampling
    assert not r.light_ctx(g).enable_presampling
    off = tframe.create_renderer(t_scene, W, H, backend="brute",
                                 presample=False)
    assert off.regir_ris_buffer is None and off.regir_params is None


def _j_pallas_tracers(port_tracers, j_scene) -> JTracers:
    """JAX's Pallas walks (interpret mode) over the port's clusters, with
    the port's per-class shapes and t_max clamped below the miss key."""
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


def test_regir_di_frame_matches_jax(cornell):
    """A DI frame (bench.py's DI validation config) with local-light
    sampling mode 2 on the same grid in both packages: display within
    rtol=atol=2e-3, reservoirs within 1e-5."""
    j_scene = cornell["j_scene"]
    jp = cornell["params"]["grid"]
    n = cornell["j_lights"].num_local_lights
    j_buf = jax.jit(jregir.presample_regir_grid, static_argnums=(0, 2, 3))(
        0, cornell["j_lights"].lights, JRegion(0, n), jp)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_renderer = dataclasses.replace(
        tframe.create_renderer(t_scene, W, H),
        regir_ris_buffer=convert.tensor_from_numpy(np.asarray(j_buf),
                                                   device=CPU),
        regir_params=_t_params(jp))
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="brute")
    j_renderer = j_renderer._replace(
        tracers=_j_pallas_tracers(t_renderer.tracers, j_scene),
        regir_ris_buffer=j_buf, regir_params=jp)

    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    g = default_gconst(cam.planar_view_constants(),
                       j_scene.num_emissive_triangles, enable_restir_di=1,
                       enable_restir_gi=0, enable_accumulation=1,
                       correct_specular_accumulation=1)
    di = g.restir_di
    g = g.replace(restir_di=dataclasses.replace(
        di, initial_sampling_params=dataclasses.replace(
            di.initial_sampling_params, num_primary_local_light_samples=4,
            local_light_sampling_mode=2),
        shading_params=dataclasses.replace(di.shading_params,
                                           enable_final_visibility=1)))
    j_state = jframe.init_frame_state(W, H)
    t_state = tframe.init_frame_state(W, H, device=CPU)
    for f in range(1):
        gf = g.replace(frame=f, blend_factor=1.0 / (f + 1))
        j_state, j_img = jframe.render_frame(j_renderer, gf, j_state)
        t_state, t_img = tframe.render_frame(
            t_renderer, convert.gconst_from_numpy(convert.to_numpy_tree(gf)),
            t_state)
        got = t_img.numpy()
        assert np.isfinite(got).all() and got.max() > 0.05
        np.testing.assert_allclose(got, np.asarray(j_img), rtol=2e-3,
                                   atol=2e-3)
        for fld in t_state.di_reservoirs[0]._fields:
            np.testing.assert_allclose(
                getattr(t_state.di_reservoirs[0], fld).numpy()
                .astype(np.float64),
                np.asarray(getattr(j_state.di_reservoirs[0], fld))
                .astype(np.float64), rtol=1e-5, atol=1e-5, err_msg=fld)
