"""The DI spatial resampling stage's kernel (csrc/di_spatial.cu through
ops/di_spatial.py) and its routing in restir/di_resampling.py::
di_spatial_resampling.

The CPU tests hold the route: the kernel on a CUDA device for bias modes
0-2, where a bridge without one (make_bridge supplies it on CUDA) raises;
every other call runs di_spatial_resampling_plain and counts
di.spatial.plain. The `cuda`-marked tests hold the kernel to the plain
version on the same inputs on the card: synthetic frames (a smooth
G-buffer with sky pixels, reservoirs of every kind, a light table of all
four light types with spot shaping and two environment records) in bias
modes 0, 1 and 2, on checkerboard fields 0-2, on a halo-padded row tile,
with lanes in the disocclusion boost and with and without a skybox. Each
case: the sample (light_data, uv_data) equal on all but 1e-3 of the lanes
(CUDA's transcendentals may differ from torch's in a last bit, which can
flip a selection), the other fields of those lanes equal (integers) or
within 2e-3 of the larger (floats), the RNG indices equal. They skip
without CUDA. The file imports no JAX, so on a machine with a card:

    python -m pytest --noconftest tests/test_torch_di_spatial_kernel.py -q -m cuda
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.lights import polymorphic as poly
from raytracer2_tpu_torch.lights.pdf_texture import fill_neighbor_offsets
from raytracer2_tpu_torch.ops import di_spatial as dsk
from raytracer2_tpu_torch.params import BACKGROUND_DEPTH, default_gconst
from raytracer2_tpu_torch.render import app_bridge
from raytracer2_tpu_torch.render.gbuffer import GBuffer
from raytracer2_tpu_torch.render.rays import active_pixel_grid
from raytracer2_tpu_torch.restir import di_resampling as dr
from raytracer2_tpu_torch.restir.di_reservoir import DIReservoir
from raytracer2_tpu_torch.scene.camera import default_camera
from raytracer2_tpu_torch.utils import packing as pk
from raytracer2_tpu_torch.utils import profiler
from raytracer2_tpu_torch.utils import rng as rtrng

CPU = torch.device("cpu")
SPATIAL = dict(num_samples=3, num_disocclusion_boost_samples=5,
               target_history_length=5, sampling_radius=12.0)
SAMPLE_FLIP_SHARE = 1e-3  # lanes whose selected sample may differ
REL = 2e-3  # float fields, relative to the larger


def _lights(g: np.random.Generator, dev) -> poly.LightInfo:
    """Every light type: 24 triangles, 6 point lights (3 of them spots),
    2 directional lights, an importance-sampled and a uniform
    environment record."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    tris = poly.store_triangle_lights(
        t(g.uniform([-4, -3, -9], [4, 3, -6], (24, 3))),
        t(g.normal(size=(24, 3))), t(g.normal(size=(24, 3))),
        t(g.uniform(0.1, 20.0, (24, 3))))
    axis = g.normal(size=(3, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    axis[:, 2] = np.abs(axis[:, 2])  # toward the surfaces (+z)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    points = poly.store_point_lights(t(g.uniform([-3, -3, -10], [3, 3, -5],
                                                 (3, 3))),
                                     t(g.uniform(1.0, 50.0, (3, 3))))
    spots = poly.store_point_lights(
        t(g.uniform([-3, -3, -10], [3, 3, -5], (3, 3))),
        t(g.uniform(1.0, 50.0, (3, 3))), cone_axis=t(axis),
        cos_cone_angle=t(g.uniform(0.3, 0.9, 3)),
        cone_softness=t(g.uniform(0.0, 0.2, 3)))
    d = g.normal(size=(2, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    suns = poly.store_directional_lights(t(d), t(g.uniform(0.5, 5, (2, 3))),
                                         t(g.uniform(0.01, 0.2, 2)))
    envs = [poly.store_environment_light((64, 32), device=dev,
                                         importance_sampled=imp,
                                         radiance_scale=(1.5, 1.0, 0.5),
                                         rotation=0.3)
            for imp in (True, False)]
    parts = [tris, points, spots, suns, *envs]
    return poly.LightInfo(*(torch.cat(fs) for fs in zip(*parts)))


def _gbuffer(g: np.random.Generator, width: int, height: int, dev
             ) -> GBuffer:
    """A smooth frame: depth a slope with ripples, 4% sky pixels, 8x8
    blocks of one normal (of four facing the camera), albedo and
    specular / roughness (roughness 0 in some blocks)."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    depth = (4.0 + 2.0 * ys / height + 0.5 * np.sin(xs / 17.0)).astype(
        np.float32)
    depth[g.random(depth.shape) < 0.04] = BACKGROUND_DEPTH
    bh, bw = (height + 7) // 8, (width + 7) // 8
    dirs = np.array([[0, 0, -1], [0.3, 0, -0.95], [0, 0.5, -0.86],
                     [-0.4, 0.2, -0.89]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    normal = dirs[g.integers(0, 4, (bh, bw))]
    albedo = g.uniform(0, 1, (bh, bw, 3)).astype(np.float32)
    spec = np.concatenate([g.uniform(0, 0.2, (bh, bw, 3)),
                           g.choice([0.0, 0.1, 0.3, 0.6, 0.9],
                                    (bh, bw, 1))], axis=-1)

    def up(block):
        full = block.repeat(8, 0).repeat(8, 1)[:height, :width]
        return torch.from_numpy(np.ascontiguousarray(full, np.float32))

    normals = pk.ndir_to_oct_unorm32(up(normal))
    return GBuffer(
        depth=torch.from_numpy(depth).to(dev), normals=normals.to(dev),
        geo_normals=normals.to(dev),
        diffuse_albedo=pk.pack_r11g11b10_ufloat(up(albedo)).to(dev),
        specular_rough=pk.pack_rgba8_gamma_ufloat(up(spec)).to(dev),
        emissive=torch.zeros((height, width, 3), device=dev))


def _reservoirs(g: np.random.Generator, shape, n_lights: int, dev
                ) -> DIReservoir:
    """Valid samples on 75% (a few past the table, which read its last
    record), M 0-8 (boost lanes below the target history of 5)."""
    valid = g.random(shape) < 0.75
    idx = g.integers(0, n_lights + 3, shape)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(dtype).to(dev)

    return DIReservoir(
        light_data=t(np.where(valid, idx | 0x80000000, 0), torch.int64),
        uv_data=t(g.integers(0, 1 << 32, shape), torch.int64),
        weight_sum=t(g.uniform(0, 3, shape), torch.float32),
        target_pdf=t(g.uniform(0, 2, shape), torch.float32),
        m=t(np.where(g.random(shape) < 0.05, 0, g.integers(1, 9, shape)),
            torch.float32),
        packed_visibility=t(g.integers(0, 1 << 18, shape), torch.int64),
        spatial_distance=t(g.integers(-3, 4, shape + (2,)), torch.int32),
        age=t(g.integers(0, 11, shape), torch.int64),
        canonical_weight=t(g.uniform(0, 1, shape), torch.float32))


def _tracers():
    """Any-hit queries that find nothing (the ray-traced mode's rays)."""
    def occluded(o, d, tmin, tmax, presorted=False):
        return torch.zeros(tmin.shape, dtype=torch.bool, device=tmin.device)

    return types.SimpleNamespace(occluded=occluded)


def make_case(dev, *, width=96, height=64, field=0, bias=2, row0=None,
              tile_rows=None, environment=1, seed=0):
    """di_spatial_resampling's arguments and bridge for a synthetic frame:
    (args, kwargs). row0 / tile_rows: a row tile of the launch grid, its
    G-buffer padded by 8 rows and its reservoir planes by ceil(radius) + 1
    rows of halo (as render/di_passes.py pads them); None: the image."""
    g = np.random.default_rng(seed)
    cam = default_camera(window_size=(width, height), position=(0.2, 0.1, -12),
                         direction=(0, 0, -1))
    view = cam.planar_view_constants()
    lights = _lights(g, dev)
    gbuf = _gbuffer(g, width, height, dev)
    sky = torch.from_numpy(g.uniform(0, 2, (32, 64, 3)).astype(
        np.float32)).to(dev)
    scene = types.SimpleNamespace(skybox=sky)
    g_const = default_gconst(view, 24, environment=environment)
    r_width = width // 2 if field else width
    planes = _reservoirs(g, (height, r_width), int(lights.center.shape[0]),
                         dev)

    row0 = 0 if row0 is None else row0
    rows = height if tile_rows is None else tile_rows
    g_base, r_base, cur = 0, 0, planes
    if tile_rows is not None:
        g_base = max(row0 - 8, 0)
        gbuf = GBuffer(*(p[g_base:row0 + rows + 8] for p in gbuf))
        halo = int(np.ceil(SPATIAL["sampling_radius"])) + 1
        r_base = max(row0 - halo, 0)
        cur = DIReservoir(*(p[r_base:row0 + rows + halo] for p in planes))
    bridge = app_bridge.make_bridge(
        scene, _tracers(), gbuf, gbuf, g_const, lights, None, None, None,
        fill_neighbor_offsets(device=dev), width, height, row_base=g_base)

    px, py = active_pixel_grid(width, rows, field, device=dev)
    py = py + row0
    surface = bridge.get_gbuffer_surface(px, py, False)
    center = DIReservoir(*(p[row0:row0 + rows] for p in planes))
    rng = rtrng.init_random_sampler(px, py, 15 + seed)
    rng = rng._replace(index=rng.index + torch.from_numpy(
        g.integers(0, 9, tuple(px.shape))).to(dev))
    spec = dr.DISpatialSpec(bias_correction_mode=bias,
                            active_checkerboard_field=field, **SPATIAL)
    return (px, py, surface, center, rng, spec, cur, bridge), dict(
        row_base=r_base)


# ---------------------------------------------------------------------------
# CPU: the route
# ---------------------------------------------------------------------------

ROUTES = {  # (device type, bias mode, runner present) -> route
    "cuda_pairwise": ("cuda", 2, True, "kernel"),
    "cuda_basic": ("cuda", 1, True, "kernel"),
    "cuda_off": ("cuda", 0, True, "kernel"),
    "cuda_ray_traced": ("cuda", 3, True, "plain"),
    "cuda_no_runner": ("cuda", 2, False, "raises"),
    "cpu": ("cpu", 2, True, "plain"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_rule(case, monkeypatch):
    """di_spatial_resampling launches the bridge's kernel on CUDA for bias
    modes 0-2, raises there on a bridge without one, and runs the plain
    version (counting di.spatial.plain) on the CPU and in mode 3. The
    route reads only px's device, the mode and the runner, so stand-ins
    for the tensors hold it without a card."""
    device_type, bias, runner, want = ROUTES[case]
    ran = []
    bridge = types.SimpleNamespace(di_spatial_kernel=(
        (lambda *a: ran.append("kernel") or "out") if runner else None))
    monkeypatch.setattr(dr, "di_spatial_resampling_plain",
                        lambda *a: ran.append("plain") or "out")
    px = types.SimpleNamespace(device=torch.device(device_type))
    spec = dr.DISpatialSpec(bias_correction_mode=bias)
    args = (px, px, None, None, None, spec, None, bridge)
    plain, kernel = _counts()
    if want == "raises":
        with pytest.raises(RuntimeError, match="di_spatial_kernel"):
            dr.di_spatial_resampling(*args)
        assert ran == []
    else:
        assert dr.di_spatial_resampling(*args) == "out"
        assert ran == [want]
    assert _counts() == (plain + (want == "plain"), kernel)


def _counts():
    c = profiler.counters()
    return c.get("di.spatial.plain", 0), c.get("di.spatial.kernel", 0)


def _assert_equal(got, want):
    for name, a, b in zip(DIReservoir._fields, got[0], want[0]):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert torch.equal(got[1].index, want[1].index)
    assert got[1].seed is want[1].seed


@pytest.mark.parametrize("bias", range(4))
def test_cpu_call_takes_the_plain_route(bias):
    """On the CPU, a bridge that carries a runner still runs the plain
    version (ray-traced mode 3 included), counts di.spatial.plain once and
    never calls the runner."""
    args, kw = make_case(CPU, bias=bias)
    called = []
    bridge = args[-1]._replace(
        di_spatial_kernel=lambda *a, **k: called.append(1))
    plain, kernel = _counts()
    got = dr.di_spatial_resampling(*args[:-1], bridge, **kw)
    assert _counts() == (plain + 1, kernel) and not called
    _assert_equal(got, dr.di_spatial_resampling_plain(*args, **kw))
    assert (got[0].m > args[3].m).any()  # some lane merged a neighbour


def test_cpu_bridge_has_no_runner():
    """make_bridge on CPU planes supplies no kernel, and the stage runs
    its plain version."""
    args, kw = make_case(CPU, field=1)
    assert args[-1].di_spatial_kernel is None
    plain, kernel = _counts()
    dr.di_spatial_resampling(*args, **kw)
    assert _counts() == (plain + 1, kernel)


@pytest.mark.parametrize("bias", [2, 3])
def test_kernel_wrapper_refuses_cpu_and_mode_3(bias):
    """The wrapper has no CPU mode and no ray-traced mode: it raises
    before it reads the frame's data."""
    args, kw = make_case(CPU, bias=bias)
    plain, kernel = _counts()
    with pytest.raises(ValueError):
        dsk.di_spatial_kernel(
            *args[:-1], kw["row_base"], gbuffer=None, view=None, width=96,
            height=64, gbuffer_row_base=0, lights=None, skybox=None,
            neighbor_offsets=args[-1].neighbor_offsets)
    assert _counts() == (plain, kernel)


def _enum(text: str, name: str, end: str) -> list[str]:
    body = text[text.index(f"enum {name} {{") + len(name) + 7:
                text.index(end)]
    return [w.strip() for line in body.splitlines()
            for w in line.split("//")[0].split(",") if w.strip()]


def test_slots_match_the_kernel():
    """The wrapper's pointer table and parameter counts are the kernel
    source's enums (csrc/di_spatial.cu)."""
    text = (Path(dsk.__file__).resolve().parent.parent / "csrc"
            / "di_spatial.cu").read_text()
    slots = _enum(text, "Slot", "S_COUNT")
    assert [s.lower().split("_", 1)[1] for s in slots[:2]] == ["px", "py"]
    assert len(slots) == len(dsk.SLOTS)
    assert len(_enum(text, "IntSlot", "I_COUNT")) == dsk.N_INTS
    assert "F_COUNT = F_CAMERA + 3" in text and dsk.N_FLOATS == 4 + 2 + 16 + 9 + 3


# ---------------------------------------------------------------------------
# The card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DI spatial kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def compare(got, want) -> dict:
    """The kernel's (got) and the plain version's (want) reservoirs and
    RNG: the lanes whose sample differs, the integer fields' and the
    float fields' disagreements on the others, the RNG indices."""
    g, w = got[0], want[0]
    flip = (g.light_data != w.light_data) | (g.uv_data != w.uv_data)
    same = ~flip
    out = {"lanes": flip.numel(), "flipped": int(flip.sum()),
           "rng_diff": int((got[1].index != want[1].index).sum())}
    for name in ("packed_visibility", "age"):
        out[name] = int((getattr(g, name) != getattr(w, name))[same].sum())
    out["spatial_distance"] = int(
        (g.spatial_distance != w.spatial_distance).any(-1)[same].sum())
    for name in ("weight_sum", "target_pdf", "m", "canonical_weight"):
        a, b = getattr(g, name)[same], getattr(w, name)[same]
        both_nan = torch.isnan(a) & torch.isnan(b)
        tol = REL * torch.maximum(a.abs(), b.abs())
        out[name] = int(((a - b).abs() > tol)[~both_nan].sum())
        out[f"{name}_bits"] = int((a.view(torch.int32)
                                   != b.view(torch.int32)).sum())
    return out


CARD_CASES = {
    "bias0": dict(bias=0),
    "bias1": dict(bias=1),
    "bias2": dict(bias=2),
    "bias2_field1": dict(bias=2, field=1),
    "bias2_field2": dict(bias=2, field=2),
    "bias1_field1": dict(bias=1, field=1),
    "bias0_field2": dict(bias=0, field=2),
    "bias2_tile": dict(bias=2, row0=96, tile_rows=64),
    "bias1_tile_field1": dict(bias=1, field=1, row0=40, tile_rows=48),
    "bias2_no_skybox": dict(bias=2, environment=0),
    "bias1_no_skybox": dict(bias=1, environment=0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_version(dev, case):
    args, kw = make_case(dev, width=384, height=256, seed=7,
                         **CARD_CASES[case])
    assert args[-1].di_spatial_kernel is not None
    plain, kernel = _counts()
    got = dr.di_spatial_resampling(*args, **kw)
    torch.cuda.synchronize()
    assert _counts() == (plain, kernel + 1)
    want = dr.di_spatial_resampling_plain(*args, **kw)
    d = compare(got, want)
    print(case, d)
    assert d["flipped"] <= SAMPLE_FLIP_SHARE * d["lanes"], d
    assert d["rng_diff"] == 0, d
    for name in ("packed_visibility", "age", "spatial_distance",
                 "weight_sum", "target_pdf", "m", "canonical_weight"):
        assert d[name] == 0, (name, d)
    # the case exercises the stage: some lanes merged, some took a
    # neighbour's sample
    assert (want[0].m > args[3].m).any()
    center = args[3]
    took = (want[0].light_data != center.light_data)
    assert took.any()
