"""The ReSTIR GI slice of the PyTorch port against the JAX package: the
packing formats of the secondary G-buffer and the GI reservoirs, the GI
reservoir library and resampling (restir/gi_reservoir.py,
restir/gi_resampling.py), and whole DI+GI frames of render_frame
(render/gi_passes.py and the GI chain of render/frame.py).

The frames render the Cornell box at 16x16 from a camera off the box's
axis in two configurations: the flagship one (bench.py's pipeline frame:
default GConst plus DI, GI temporal and spatial off) and the goldens' one
(GI temporal and spatial on). Both packages trace through the same
clusters with the same bundle shapes: JAX's Pallas walks in interpret
mode, the port's plain walks and plain cull passes. Display, diffuse and
specular agree within rtol=atol=2e-3, the GI reservoirs within 1e-5 and
the secondary G-buffer's integer planes bit for bit.
"""


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
from raytracer2_tpu.restir import gi_reservoir as jres
from raytracer2_tpu.restir import gi_resampling as jgr
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu.utils import packing as jpk
from raytracer2_tpu.utils import rng as jrng
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.render import app_bridge as tab
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.render import gbuffer as tgb
from raytracer2_tpu_torch.render import gi_passes as tgi
from raytracer2_tpu_torch.restir import gi_reservoir as tres
from raytracer2_tpu_torch.restir import gi_resampling as tgr
from raytracer2_tpu_torch.utils import packing as tpk
from raytracer2_tpu_torch.utils import rng as trng

W = H = 16
CPU = torch.device("cpu")
FRAMES = 2
CONFIGS = {
    # bench.py:266-272: the default GConst plus DI
    "flagship": dict(enable_restir_di=1),
    # tests/test_goldens.py:39-43
    "goldens": dict(enable_restir_di=1, enable_restir_gi=1,
                    enable_temporal_resampling=1,
                    enable_spatial_resampling=1),
}


# ---------------------------------------------------------------------------
# Packing formats
# ---------------------------------------------------------------------------

def _packing_inputs(rng, n=512):
    f32 = np.float32
    hdr = np.concatenate([rng.uniform(0, 4, (n, 4)),
                          rng.uniform(-70000, 70000, (n, 4)),
                          rng.normal(scale=1e-5, size=(n, 4))]).astype(f32)
    hdr[:8] = [0.0, -0.0, np.inf, np.nan]
    normals = rng.normal(size=(n, 3)).astype(f32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    normals[:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0],
                   [0.6, 0, -0.8], [0, 0, 0]]
    snorm = rng.uniform(-1.3, 1.3, (n, 2)).astype(f32)
    snorm[:4] = [[np.nan, 0.5], [1.0, -1.0], [0.5 / 32767, -1.5 / 32767],
                 [0.0, -0.0]]
    color = np.concatenate([rng.uniform(0, 5, (n, 3)),
                            rng.uniform(0, 1e-3, (n // 4, 3)),
                            rng.uniform(100, 6e4, (n // 4, 3))]).astype(f32)
    color[:3] = [[0, 0, 0], [1, 0, 0], [0, 0, 1e-9]]
    words = rng.integers(0, 1 << 32, (n, 2), dtype=np.int64)
    words[:3, 0] = [0, 0xFFFFFFFF, 0x7FFF8000]
    return dict(hdr=hdr, normals=normals, snorm=snorm, color=color,
                words=words)


PACKING_CASES = [
    ("pack_r16g16_float", "hdr", lambda a: a[:, :2]),
    ("unpack_r16g16_float", "words", lambda a: a[:, 0]),
    ("pack_r16g16b16a16_float", "hdr", lambda a: a),
    ("unpack_r16g16b16a16_float", "words", lambda a: a),
    ("pack_snorm2x16", "snorm", lambda a: a),
    ("unpack_snorm2x16", "words", lambda a: a[:, 0]),
    ("encode_normal_snorm2x16", "normals", lambda a: a),
    ("decode_normal_snorm2x16", "words", lambda a: a[:, 0]),
    ("encode_rgb_to_logluv", "color", lambda a: a),
    ("decode_logluv_to_rgb", "words", lambda a: a[:, 0]),
]


# float decodes that go through library math XLA rounds its own way, with
# the relative tolerance that covers it: the octahedral decode's fused
# sum of squares (an ulp or two), XLA's exp2 on the CPU (up to ~3e-5 off
# the correctly rounded value, where torch's is within an ulp)
DECODE_RTOL = {"decode_normal_snorm2x16": 1e-6, "decode_logluv_to_rgb": 1e-4}


@pytest.mark.parametrize("name,src,pick", PACKING_CASES,
                         ids=[c[0] for c in PACKING_CASES])
def test_packing_formats_bit_exact(name, src, pick):
    """Each format of the secondary G-buffer and the GI reservoirs, in
    both packages: every packed word and every float unpack bit for bit
    (NaN where JAX gives NaN); the two decodes of DECODE_RTOL within it."""
    a = pick(_packing_inputs(np.random.default_rng(53))[src])
    want = np.asarray(getattr(jpk, name)(
        jnp.asarray(a.astype(np.uint32) if a.dtype == np.int64 else a)))
    got = getattr(tpk, name)(torch.from_numpy(np.ascontiguousarray(a)))
    got = got.numpy()
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(got, want.astype(np.int64))
    elif name in DECODE_RTOL:
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=DECODE_RTOL[name],
                                   atol=1e-30)
    else:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _random_gi_reservoir(rng, shape):
    """One GI reservoir per lane, as numpy fields (uint32 as int64)."""
    f32 = np.float32
    normal = rng.normal(size=shape + (3,)).astype(f32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    m = rng.integers(0, 300, shape)
    m[rng.uniform(size=shape) < 0.2] = 0
    return dict(position=rng.uniform(-3, 3, shape + (3,)).astype(f32),
                normal=normal,
                radiance=rng.uniform(0, 8, shape + (3,)).astype(f32),
                weight_sum=rng.uniform(0, 2, shape).astype(f32),
                m=m, age=rng.integers(0, 300, shape))


def _j_gi(fields):
    return jres.GIReservoir(**{
        k: jnp.asarray(v.astype(np.uint32) if v.dtype == np.int64 else v)
        for k, v in fields.items()})


def _assert_fields_equal(got, want):
    for f in want._fields:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=f)
        else:
            np.testing.assert_array_equal(b, a.astype(np.int64), err_msg=f)


def test_gi_reservoir_pack_unpack_matches_jax():
    """pack_gi_reservoir bit for bit, unpack_gi_reservoir bit for bit but
    for its two decodes (DECODE_RTOL), and make_gi_reservoir, where_gi and
    is_valid bit for bit; M and age clamp at 255."""
    rng = np.random.default_rng(54)
    fields = _random_gi_reservoir(rng, (300,))
    j, t = _j_gi(fields), convert.gi_reservoir_from_numpy(fields, device=CPU)
    jp, tp = jres.pack_gi_reservoir(j, 0xABCD0000), tres.pack_gi_reservoir(
        t, 0xABCD0000)
    _assert_fields_equal(tp, jp)
    got, want = tres.unpack_gi_reservoir(tp), jres.unpack_gi_reservoir(jp)
    for f, rtol in (("normal", DECODE_RTOL["decode_normal_snorm2x16"]),
                    ("radiance", DECODE_RTOL["decode_logluv_to_rgb"])):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=1e-30, err_msg=f)
    for f in ("position", "weight_sum", "m", "age"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.asarray(getattr(want, f)).astype(getattr(got, f).numpy().dtype),
            err_msg=f)
    assert int(tres.unpack_gi_reservoir(tp).m.max()) == tres.MAX_M
    pdf = rng.uniform(-0.5, 2, 300).astype(np.float32)
    made_j = jres.make_gi_reservoir(j.position, j.normal, j.radiance,
                                    jnp.asarray(pdf))
    made_t = tres.make_gi_reservoir(t.position, t.normal, t.radiance,
                                    torch.from_numpy(pdf))
    _assert_fields_equal(made_t, made_j)
    mask = rng.uniform(size=300) < 0.5
    _assert_fields_equal(
        tres.where_gi(torch.from_numpy(mask), made_t, t),
        jres.where_gi(jnp.asarray(mask), made_j, j))
    np.testing.assert_array_equal(tres.is_valid(made_t).numpy(),
                                  np.asarray(jres.is_valid(made_j)))


# ---------------------------------------------------------------------------
# Whole frames
# ---------------------------------------------------------------------------

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
    p = tmp_path_factory.mktemp("gi") / "cornell.glb"
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
    gconsts = {name: default_gconst(view, j_scene.num_emissive_triangles,
                                    **kw) for name, kw in CONFIGS.items()}
    return dict(j_scene=j_scene, t_scene=t_scene, j_renderer=j_renderer,
                t_renderer=t_renderer, gconsts=gconsts)


def _t_g(j_g):
    return convert.gconst_from_numpy(convert.to_numpy_tree(j_g))


@pytest.fixture(scope="module")
def frames(cornell):
    """FRAMES frames of render_frame per configuration in both packages
    from fresh states: {config: [(JAX state, JAX display, port state, port
    display)]}."""
    out = {}
    for name, j_g in cornell["gconsts"].items():
        j_state = jframe.init_frame_state(W, H)
        t_state = tframe.init_frame_state(W, H, device=CPU)
        out[name] = []
        for f in range(FRAMES):
            g = j_g.replace(frame=f)
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


SECONDARY_INT_PLANES = ("normal", "throughput", "diffuse_albedo",
                        "specular_and_roughness")


@pytest.mark.parametrize("config,frame",
                         [(c, f) for c in CONFIGS for f in range(FRAMES)])
def test_render_frame_gi_matches_jax(frames, config, frame):
    j_state, j_img, t_state, t_img = frames[config][frame]
    _close(t_img, j_img, "display")
    _close(t_state.diffuse_lighting, j_state.diffuse_lighting, "diffuse")
    _close(t_state.specular_lighting, j_state.specular_lighting, "specular")
    assert float(t_img.max()) > 0.05  # lit, not black
    for f in SECONDARY_INT_PLANES:
        np.testing.assert_array_equal(
            getattr(t_state.secondary, f).numpy(),
            np.asarray(getattr(j_state.secondary, f)).astype(np.int64),
            err_msg=f)
    sec = t_state.secondary
    assert (sec.throughput[..., 0] != 0).float().mean() > 0.5
    # float planes: a bounce that escapes stores its position 1,000 units
    # out along its direction, where an ulp of the direction is ~1e-4
    for f in ("world_pos", "emission", "pdf"):
        np.testing.assert_allclose(
            getattr(sec, f).numpy(), np.asarray(getattr(j_state.secondary, f)),
            rtol=1e-4, atol=1e-5, err_msg=f)
    for slot in range(2):
        n = _differences(t_state.gi_reservoirs[slot],
                         j_state.gi_reservoirs[slot])
        assert n == 0, f"slot {slot}: {n} GI reservoir values differ"
    # the chain ran: valid initial reservoirs in the secondary slot
    assert (t_state.gi_reservoirs[0].m > 0).float().mean() > 0.3


def test_gi_state_carries_across(frames):
    """convert.gi_reservoir_from_numpy and secondary_gbuffer_from_numpy
    carry JAX's state across value for value, in the port's dtypes."""
    j_state, _, t_state, _ = frames["goldens"][-1]
    pairs = [(convert.gi_reservoir_from_numpy, j, t)
             for j, t in zip(j_state.gi_reservoirs, t_state.gi_reservoirs)]
    pairs.append((convert.secondary_gbuffer_from_numpy, j_state.secondary,
                  t_state.secondary))
    for fn, j, t in pairs:
        carried = fn(convert.to_numpy_tree(j), device=CPU)
        assert type(carried) is type(t)
        for a, b, w in zip(carried, t, j):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(w).astype(a.numpy().dtype))


def test_gi_passes_row_bands_change_nothing(cornell, monkeypatch):
    """Above _BAND_THRESHOLD lanes the BRDF-ray, secondary and final
    passes run in row bands; every RNG stream is seeded by pixel
    coordinates and the exact cull's hits do not depend on the batch, so
    the bands change no value."""
    tr = cornell["t_renderer"]
    g = _t_g(cornell["gconsts"]["goldens"])
    state = tframe.init_frame_state(W, H, device=CPU)
    s1, whole = tframe.render_frame(tr, g, state)
    _, whole2 = tframe.render_frame(tr, g.replace(frame=1), s1)
    monkeypatch.setattr(tgi, "_BAND_THRESHOLD", 2 * W * 3)  # bands of 3 rows
    b1, banded = tframe.render_frame(tr, g, state)
    _, banded2 = tframe.render_frame(tr, g.replace(frame=1), b1)
    np.testing.assert_array_equal(banded.numpy(), whole.numpy())
    np.testing.assert_array_equal(banded2.numpy(), whole2.numpy())
    for a, b in zip(b1.gi_reservoirs[0], s1.gi_reservoirs[0]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# The resampling library on synthetic reservoirs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridges(cornell, frames):
    """Both packages' bridges over the goldens run's last two G-buffers
    (JAX's, carried across), with that frame's GConst."""
    j_state = frames["goldens"][-1][0]
    g = cornell["gconsts"]["goldens"].replace(frame=FRAMES - 1)
    t_g = _t_g(g)
    jr, tr = cornell["j_renderer"], cornell["t_renderer"]
    jl, tl = jr.scene_lights, tr.scene_lights
    j_bridge = j_make_bridge(
        cornell["j_scene"], jr.tracers, j_state.gbuffer, j_state.prev_gbuffer,
        g, jl.lights, jl.geometry_to_light, jl.local_pdf_mips,
        jl.env_pdf_mips, jr.neighbor_offsets, W, H)
    gbuf, prev = (convert.gbuffer_from_numpy(convert.to_numpy_tree(x),
                                             device=CPU)
                  for x in (j_state.gbuffer, j_state.prev_gbuffer))
    t_bridge = tab.make_bridge(
        cornell["t_scene"], tr.tracers, gbuf, prev, t_g, tl.lights,
        tl.geometry_to_light, tl.local_pdf_mips, tl.env_pdf_mips,
        tr.neighbor_offsets, W, H)
    return dict(j=j_bridge, t=t_bridge, j_g=g, t_g=t_g,
                j_surface=jgb.surface_from_gbuffer_grid(j_state.gbuffer,
                                                        g.view),
                t_surface=tgb.surface_from_gbuffer_grid(gbuf, t_g.view))


def _synthetic_inputs(bridges, seed):
    """Flattened pixel grid, surfaces, input reservoirs (sample points on
    the box's walls in front of each pixel), RNG states, motion, and a
    source [H, W] reservoir buffer, for both packages."""
    rng = np.random.default_rng(seed)
    px, py = np.meshgrid(np.arange(W, dtype=np.int32),
                         np.arange(H, dtype=np.int32))
    px, py = px.reshape(-1), py.reshape(-1)
    inp = _random_gi_reservoir(rng, (W * H,))
    src = _random_gi_reservoir(rng, (H, W))
    surf = np.asarray(bridges["j_surface"].world_pos).reshape(-1, 3)
    # samples a few units from the primary surfaces, normals facing them
    for res, pos in ((inp, surf), (src, surf.reshape(H, W, 3))):
        res["position"] = (pos + rng.uniform(-2, 2, pos.shape)).astype(
            np.float32)
        n = pos - res["position"] + rng.normal(scale=0.3, size=pos.shape)
        res["normal"] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                         ).astype(np.float32)
    motion = rng.uniform(-1.5, 1.5, (W * H, 3)).astype(np.float32)
    motion[:, 2] *= 0.05
    max_age = rng.integers(10, 60, W * H)
    j_rng = jrng.init_random_sampler(jnp.asarray(px, jnp.uint32),
                                     jnp.asarray(py, jnp.uint32),
                                     jnp.uint32(7 * 13 + 1))
    t_rng = trng.init_random_sampler(torch.from_numpy(px),
                                     torch.from_numpy(py), 7 * 13 + 1)
    flat = lambda s, to: type(s)(*(to(np.asarray(f).reshape(
        (W * H,) + np.asarray(f).shape[2:])) for f in s))
    return dict(
        j=dict(px=jnp.asarray(px), py=jnp.asarray(py),
               surface=flat(bridges["j_surface"], jnp.asarray),
               inp=_j_gi(inp), src=_j_gi(src), rng=j_rng,
               motion=jnp.asarray(motion),
               max_age=jnp.asarray(max_age, jnp.uint32)),
        t=dict(px=torch.from_numpy(px), py=torch.from_numpy(py),
               surface=type(bridges["t_surface"])(*(
                   f.reshape((W * H,) + f.shape[2:])
                   for f in bridges["t_surface"])),
               inp=convert.gi_reservoir_from_numpy(inp, device=CPU),
               src=convert.gi_reservoir_from_numpy(src, device=CPU),
               rng=t_rng, motion=torch.from_numpy(motion),
               max_age=torch.from_numpy(max_age)))


@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("stage", ["temporal", "spatial"])
def test_gi_resampling_matches_jax(bridges, stage, mode):
    """gi_temporal_resampling / gi_spatial_resampling on synthetic
    reservoirs in every bias-correction mode (mode 3 casts its visibility
    rays through each package's tracers), within 1e-5, and the RNG
    counters equal."""
    ins = _synthetic_inputs(bridges, 55 + mode)
    out = {}
    for pkg, lib, bridge in (("j", jgr, bridges["j"]),
                             ("t", tgr, bridges["t"])):
        a = ins[pkg]
        if stage == "temporal":
            spec = lib.GITemporalSpec(bias_correction_mode=mode,
                                      enable_permutation_sampling=mode == 1)
            out[pkg] = lib.gi_temporal_resampling(
                a["px"], a["py"], a["surface"], a["inp"], a["rng"], spec,
                a["motion"], jnp.uint32(6) if pkg == "j" else 6,
                a["max_age"], a["src"], bridge)
        else:
            spec = lib.GISpatialSpec(bias_correction_mode=mode,
                                     num_samples=3, sampling_radius=4.0)
            out[pkg] = lib.gi_spatial_resampling(
                a["px"], a["py"], a["surface"], a["inp"], a["rng"], spec,
                a["src"], bridge)
    (j_res, j_state), (t_res, t_state) = out["j"], out["t"]
    assert _differences(t_res, j_res) == 0
    np.testing.assert_array_equal(t_state.index.numpy(),
                                  np.asarray(j_state.index).astype(np.int64))
    # the merge took neighbours' samples on some lanes
    moved = (t_res.position != ins["t"]["inp"].position).any(dim=-1)
    assert 0 < int(moved.sum()) < W * H


def test_gi_boiling_filter_and_jacobian_match_jax():
    rng = np.random.default_rng(56)
    res = _random_gi_reservoir(rng, (20, 37))
    res["weight_sum"][3, 5] = 200.0  # a firefly the filter kills
    got = tgr.gi_boiling_filter(
        convert.gi_reservoir_from_numpy(res, device=CPU), 0.3)
    want = jgr.gi_boiling_filter(_j_gi(res), 0.3)
    _assert_fields_equal(got, want)
    assert int(got.m[3, 5]) == 0
    a, b = (rng.uniform(-3, 3, (64, 3)).astype(np.float32) for _ in "ab")
    nb = _random_gi_reservoir(rng, (64,))
    np.testing.assert_allclose(
        tgr.calculate_jacobian(torch.from_numpy(a), torch.from_numpy(b),
                               convert.gi_reservoir_from_numpy(
                                   nb, device=CPU)).numpy(),
        np.asarray(jgr.calculate_jacobian(jnp.asarray(a), jnp.asarray(b),
                                          _j_gi(nb))), rtol=1e-5, atol=1e-6)
