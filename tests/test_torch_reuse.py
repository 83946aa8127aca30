"""The port's four reuse stages against the benchmark's plain reference
(portbench/reference/resampling.py, judged by portbench/checks/reuse.py)
on a small corridor seen from two camera poses, with seeded random
reservoirs: GI temporal and spatial resampling, DI temporal and spatial
resampling. Planted faults read not correct: the GI history clamp
dropped, the GI Jacobian dropped, half the DI spatial radius, and (a
whole tiny benchmark run) the previous frame's GI reservoirs taken from
the wrong slot. Also the banded path (render/banding.py): a shrunken lane
threshold gives a bit-equal frame and one "band" count a band; and the DI
stages' spans, which fire only under the DI resampling modes."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import check, harness
from portbench.reference import glb as ref_glb
from portbench.reference import resampling as rs
from raytracer2_tpu_torch.models import procedural
from raytracer2_tpu_torch.render import di_passes
from raytracer2_tpu_torch.render import frame as fr
from raytracer2_tpu_torch.render import gi_passes
from raytracer2_tpu_torch.render.app_bridge import make_bridge
from raytracer2_tpu_torch.render.gbuffer import surface_from_gbuffer_grid
from raytracer2_tpu_torch.restir import gi_resampling
from raytracer2_tpu_torch.restir.di_reservoir import DIReservoir
from raytracer2_tpu_torch.restir.di_resampling import (
    DISpatialSpec, DITemporalSpec, di_spatial_resampling,
    di_temporal_resampling)
from raytracer2_tpu_torch.restir.gi_reservoir import GIReservoir
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.camera import default_camera
from raytracer2_tpu_torch.scene.scene import build_scene
from raytracer2_tpu_torch.utils import profiler
from raytracer2_tpu_torch.utils import rng as rtrng

ROOT = Path(__file__).resolve().parent.parent
CELL = "ladder-4k.flythrough"
W, H = 64, 36
DIRECTION = (0.0, 0.0, 1.0)
PREV, CUR = (0.3, 4.0, 15.0), (0.45, 4.1, 14.2)  # the camera moved
FRAME = 0x9E3779B9
reuse = check.load_check("reuse")


def _mix():
    return json.loads((ROOT / "portbench" / "traffic" / "flythrough.json")
                      .read_text())


def _limit(name: str) -> float:
    limits = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json")
                        .read_text())
    return limits[name]["max"]


def _view(position):
    return default_camera(window_size=(W, H), position=position,
                          direction=DIRECTION).planar_view_constants()


class Recorder:
    def __init__(self):
        self.spans, self.counts = [], []

    def span(self, name, host_t0, host_t1, ev0, ev1):
        self.spans.append(name)

    def count(self, name, n):
        self.counts.append((name, n))


@pytest.fixture
def tracing():
    sink = Recorder()
    profiler.enable(sink)
    yield sink
    profiler.disable()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corridor, its renderer, the two poses' G-buffers, the frame's
    bridge and primary surface, and seeded random reservoirs."""
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    glb = procedural.corridor_glb(segments=4, pillars_per_side=4, lat=12,
                                  lon=16)
    path = tmp_path_factory.mktemp("reuse") / "scene.glb"
    path.write_bytes(glb)
    scene = build_scene(gltf.load_file(path), device=cpu)
    renderer = fr.create_renderer(scene, W, H)
    lights = renderer.scene_lights
    mix = _mix()
    v0, v1 = _view(PREV), _view(CUR)
    g0 = harness.make_gconst(mix, v0, v0, lights.num_local_lights, FRAME - 1)
    g1 = harness.make_gconst(mix, v1, v0, lights.num_local_lights, FRAME)
    state = fr.init_frame_state(W, H, device=cpu)
    _, (gb0, _) = fr.render_frame(renderer, g0, state, stop_after="gbuffer")
    _, (gb1, motion) = fr.render_frame(renderer, g1, state,
                                       stop_after="gbuffer")
    bridge = make_bridge(scene, renderer.tracers, gb1, gb0, g1, lights.lights,
                         lights.geometry_to_light, lights.local_pdf_mips,
                         lights.env_pdf_mips, renderer.neighbor_offsets, W, H)
    primary = surface_from_gbuffer_grid(gb1, v1)

    gen = torch.Generator().manual_seed(20)

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen)

    def gi_res():
        # samples on the scene's surfaces: world positions of random pixels
        pick = ints(0, W * H, H, W)
        normal = torch.nn.functional.normalize(uniform(H, W, 3, lo=-1.0),
                                               dim=-1)
        return GIReservoir(
            position=primary.world_pos.reshape(-1, 3)[pick],
            normal=normal, radiance=uniform(H, W, 3, hi=4.0),
            weight_sum=uniform(H, W, lo=0.01, hi=2.0),
            m=ints(0, 40, H, W), age=ints(0, 60, H, W))

    n_lights = lights.num_local_lights

    def di_res():
        light = torch.where(uniform(H, W) < 0.85,
                            ints(0, n_lights, H, W) | 0x80000000, 0)
        return DIReservoir(
            light_data=light, uv_data=ints(0, 1 << 32, H, W),
            weight_sum=uniform(H, W, lo=0.01, hi=3.0),
            target_pdf=uniform(H, W, lo=0.01, hi=3.0),
            m=ints(0, 30, H, W).float(),
            packed_visibility=torch.zeros((H, W), dtype=torch.int64),
            spatial_distance=ints(-3, 4, H, W, 2).to(torch.int32),
            age=ints(0, 20, H, W), canonical_weight=torch.zeros(H, W))

    px, py = torch.meshgrid(torch.arange(W), torch.arange(H), indexing="xy")
    rng = rtrng.RngState(seed=ints(0, 1 << 32, H, W), index=ints(1, 9, H, W))
    return dict(
        scene=scene, ref_scene=ref_glb.load_glb(glb, cpu), renderer=renderer,
        g=g1, bridge=bridge, primary=primary, motion=motion,
        planes=reuse._planes(gb1), prev_planes=reuse._planes(gb0),
        cam=rs.Camera(CUR, DIRECTION, W, H),
        prev_cam=rs.Camera(PREV, DIRECTION, W, H),
        gi=(gi_res(), gi_res()), di=(di_res(), di_res()), rng=rng,
        px=px.to(torch.int32), py=py.to(torch.int32),
        params=reuse.params(mix["gconst"]))


def _pixels(w):
    """Every foreground pixel of the current G-buffer."""
    lin = torch.nonzero(w["planes"].depth.reshape(-1)
                        != rs.BACKGROUND_DEPTH)[:, 0]
    return lin % W, lin // W


def _t_spec(g):
    trp = g.restir_di.temporal_resampling_params
    return DITemporalSpec(
        max_history_length=trp.max_history_length,
        bias_correction_mode=trp.temporal_bias_correction,
        depth_threshold=trp.temporal_depth_threshold,
        normal_threshold=trp.temporal_normal_threshold)


def _s_spec(g, radius_scale: float = 1.0):
    srp = g.restir_di.spatial_resampling_params
    return DISpatialSpec(
        num_samples=srp.num_spatial_samples,
        num_disocclusion_boost_samples=srp.num_disocclusion_boost_samples,
        target_history_length=(g.restir_di.temporal_resampling_params
                               .max_history_length),
        bias_correction_mode=srp.spatial_bias_correction,
        sampling_radius=srp.spatial_sampling_radius * radius_scale,
        depth_threshold=srp.spatial_depth_threshold,
        normal_threshold=srp.spatial_normal_threshold,
        neighbor_offset_mask=srp.neighbor_offset_mask)


def _bad_share(stage: str, w, radius_scale: float = 1.0) -> float:
    """The program's stage on the whole grid against the reference at
    every foreground pixel: the share of bad pixels (checks/reuse.py)."""
    g, bridge, primary = w["g"], w["bridge"], w["primary"]
    gi_p, di_p = w["params"]
    x, y = _pixels(w)
    ref_lights = rs.stored_lights(w["ref_scene"], x.device)
    offsets = rs.neighbor_offsets()
    planes, cam = w["planes"], w["cam"]
    if stage == "gi_temporal":
        cur, prev = w["gi"]
        got = gi_passes.gi_temporal_pass(g, bridge, cur, prev, w["motion"],
                                         W, H, primary_surface=primary)
        ref, _ = rs.gi_temporal(x, y, planes, cam, w["prev_planes"],
                                w["prev_cam"], w["motion"][y, x], g.frame,
                                reuse._at(reuse._gi(cur), x, y),
                                reuse._gi(prev), gi_p)
        return float(reuse.gi_bad(reuse._at(reuse._gi(got), x, y), ref)
                     .float().mean())
    if stage == "gi_spatial":
        cur = w["gi"][0]
        got = gi_passes.gi_spatial_pass(g, bridge, cur, W, H,
                                        primary_surface=primary)
        ref = rs.gi_spatial(x, y, planes, cam, g.frame,
                            reuse._at(reuse._gi(cur), x, y), reuse._gi(cur),
                            gi_p, offsets)
        return float(reuse.gi_bad(reuse._at(reuse._gi(got), x, y), ref)
                     .float().mean())
    rng = w["rng"]
    seed, index = rng.seed[y, x], rng.index[y, x]
    if stage == "di_temporal":
        cur, prev = w["di"]
        got, _ = di_temporal_resampling(
            w["px"], w["py"], primary, cur, rng, _t_spec(g), w["motion"], 0,
            prev, bridge)
        ref = rs.di_temporal(x, y, planes, cam, w["prev_planes"],
                             w["prev_cam"], w["motion"][y, x], seed, index,
                             reuse._at(reuse._di(cur), x, y), reuse._di(prev),
                             ref_lights, di_p)
    else:
        cur = w["di"][0]
        got, _ = di_spatial_resampling(w["px"], w["py"], primary, cur, rng,
                                       _s_spec(g, radius_scale), cur, bridge)
        ref = rs.di_spatial(x, y, planes, cam, seed, index,
                            reuse._at(reuse._di(cur), x, y), reuse._di(cur),
                            ref_lights, di_p, offsets)
    return float(reuse.di_bad(reuse._at(reuse._di(got), x, y), ref)
                 .float().mean())


@pytest.mark.parametrize("stage", reuse.STAGES)
def test_the_stage_matches_the_plain_reference(world, stage):
    assert _bad_share(stage, world) == 0.0


def test_the_history_clamp_dropped_is_not_correct(world, monkeypatch):
    real = gi_resampling.gi_temporal_resampling

    def unclamped(*args, **kwargs):
        args = list(args)
        args[5] = dataclasses.replace(args[5], max_history_length=255)
        return real(*args, **kwargs)

    monkeypatch.setattr(gi_resampling, "gi_temporal_resampling", unclamped)
    assert _bad_share("gi_temporal", world) > _limit("gi_temporal_bad_share")


@pytest.mark.parametrize("stage", ["gi_temporal", "gi_spatial"])
def test_the_jacobian_dropped_is_not_correct(world, stage, monkeypatch):
    monkeypatch.setattr(gi_resampling, "calculate_jacobian",
                        lambda recv, n_recv, res: torch.ones_like(
                            res.weight_sum))
    assert _bad_share(stage, world) > _limit(f"{stage}_bad_share")


def test_half_the_di_radius_is_not_correct(world):
    assert _bad_share("di_spatial", world, radius_scale=0.5) > _limit(
        "di_spatial_bad_share")


def _wrong_slot(monkeypatch):
    """The GI temporal stage reads the slot the previous frame's temporal
    output went to, not its spatial output."""
    real = fr.render_frame

    def wrong(renderer, g, state, *args, **kwargs):
        gi = g.restir_gi
        g = g.replace(restir_gi=dataclasses.replace(
            gi, buffer_indices=dataclasses.replace(
                gi.buffer_indices, temporal_resampling_input_buffer_index=0)))
        return real(renderer, g, state, *args, **kwargs)

    monkeypatch.setattr(fr, "render_frame", wrong)


@pytest.mark.parametrize("fault", [None, _wrong_slot])
def test_a_tiny_run_of_the_cell(fault, monkeypatch):
    """The cell through the whole benchmark at a tiny size: correct, and
    not correct with the previous frame's GI reservoirs from the wrong
    slot."""
    from portbench.tests.conftest import run_tiny, tiny_cell

    if fault is not None:
        fault(monkeypatch)
    out = run_tiny(tiny_cell(CELL), seconds=0.0)  # one window frame
    share = out["checks"]["gi_temporal_bad_share"]["value"]
    if fault is None:
        assert out["correct"], out["checks"]
        assert out["checks"]["gi_temporal_reused_share"]["value"] > 0.5
    else:
        assert not out["correct"]
        assert share > _limit("gi_temporal_bad_share")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def test_the_banded_path_is_bit_equal_and_counts_its_bands(world, tracing,
                                                          monkeypatch):
    renderer, g = world["renderer"], world["g"]
    state = fr.init_frame_state(W, H, device=torch.device("cpu"))
    whole = fr.render_frame(renderer, g, state)
    assert not [c for c in tracing.counts if c[0] == "band"]
    monkeypatch.setattr(gi_passes, "_BAND_THRESHOLD", 1024)
    banded = fr.render_frame(renderer, g, state)
    # bands of 1024 // 2 // 64 = 8 rows: 5 a pass, in BRDF rays,
    # secondary shading and GI final shading
    assert [c for c in tracing.counts if c[0] == "band"] == [("band", 1)] * 15
    for a, b in zip(_leaves(whole), _leaves(banded)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode, spans", [
    (0, []), (1, ["pass.di.temporal"]), (2, ["pass.di.spatial"]),
    (3, ["pass.di.temporal", "pass.di.spatial"])])
def test_the_di_stage_spans_fire_only_under_resampling(world, tracing, mode,
                                                       spans):
    w = world
    g = w["g"].replace(enable_di_resampling=mode)
    lights = w["renderer"].light_ctx(g)
    img = torch.zeros((H, W, 3))
    di_passes.di_fused_resampling_pass(
        g, w["bridge"], lights, img, img, W, H, primary_surface=w["primary"],
        motion=w["motion"], prev_di_reservoirs=w["di"][1])
    assert [s for s in tracing.spans if s.startswith("pass.di.")] == spans
