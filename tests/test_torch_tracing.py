"""The port's spans and counters (utils/profiler.py: span, count, enable,
disable) and its counted host reads (utils/readback.py) on a small
corridor: off, a span is one shared no-op and the sink hears nothing; on,
a frame is bit-equal to one rendered with them off, its spans nest as the
frame's passes and the bundle walk's parts do, the "readback" counter
matches the trace calls and their fallbacks, and torch.profiler's events
carry the prefix given to enable().

The `cuda`-marked test runs one frame of each benchmark cell's mix at a
reduced size on the card under torch.cuda.set_sync_debug_mode("warn") and
requires every synchronising call to come from inside a readback.* span:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda

(this file imports no JAX; tests/conftest.py does, hence --noconftest).
"""

import json
import time
import traceback
import warnings
from pathlib import Path

import pytest
import torch

from portbench.harness import make_gconst
from raytracer2_tpu_torch.models import procedural
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.params import default_gconst
from raytracer2_tpu_torch.render import frame as fr
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.camera import default_camera
from raytracer2_tpu_torch.scene.scene import build_scene
from raytracer2_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parent.parent
W, H = 16, 8
CAMERA = dict(position=(0.3, 4.0, 15.0), direction=(0.0, 0.0, 1.0))


class Recorder:
    """A sink that keeps every span (name, host t0, host t1) and count."""

    def __init__(self):
        self.spans, self.counts = [], []

    def span(self, name, host_t0, host_t1, ev0, ev1):
        self.spans.append((name, host_t0, host_t1))

    def count(self, name, n):
        self.counts.append((name, n))

    def names(self):
        return [s[0] for s in self.spans]


@pytest.fixture
def tracing():
    """enable(Recorder()) for one test, always disabled after it."""
    sink = Recorder()
    profiler.enable(sink)
    yield sink
    profiler.disable()


def _scene(tmp_path_factory, device, glb: bytes):
    p = tmp_path_factory.mktemp("tracing") / "scene.glb"
    p.write_bytes(glb)
    return build_scene(gltf.load_file(p), device=device)


def _view(w, h, position, direction):
    return default_camera(window_size=(w, h), position=position,
                          direction=direction).planar_view_constants()


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    """A 4-segment corridor, its renderer, and one over 16-triangle
    clusters at k_cand 2, whose bundles overflow and take the partial
    fallback."""
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    scene = _scene(tmp_path_factory, cpu, procedural.corridor_glb(
        segments=4, pillars_per_side=4, lat=12, lon=16))
    return dict(
        scene=scene, renderer=fr.create_renderer(scene, W, H),
        overflowing=fr.create_renderer(
            scene, W, H, tracer_opts=dict(cluster_size=16, k_cand=2)),
        view=_view(W, H, **CAMERA))


def _frame(renderer, view, **gconst):
    g = default_gconst(view, renderer.scene_lights.num_local_lights,
                       **gconst).replace(prev_view=view, frame=7)
    state = fr.init_frame_state(W, H, device=torch.device("cpu"))
    return fr.render_frame(renderer, g, state)


def _mix_gconst(name: str, view, num_lights: int):
    """The GConst of a benchmark cell's traffic mix
    (portbench/traffic/<name>.json), as the benchmark makes it."""
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                     .read_text())
    return make_gconst(mix, view, view, num_lights, frame=11)


RESTIR = dict(enable_restir_di=1)
REFERENCE = dict(refrence_mode=1)


def _leaves(tree):
    """The tensors of a (nested) NamedTuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parent(spans, s):
    """The innermost span that holds s."""
    holders = [o for o in spans if o is not s and _inside(s, o)]
    return min(holders, key=lambda o: o[2] - o[1])[0] if holders else None


def test_off_is_one_shared_no_op_and_the_sink_hears_nothing(corridor):
    assert profiler.span("pass.gbuffer") is profiler.span("trace.walk")
    with profiler.span("pass.gbuffer") as inside:
        assert inside is None
    sink = Recorder()
    profiler.enable(sink)
    profiler.disable()
    before = profiler.counters().get("readback", 0)
    _frame(corridor["renderer"], corridor["view"], **RESTIR)
    assert sink.spans == [] and sink.counts == []
    # the counters are kept with the spans off
    assert profiler.counters()["readback"] > before


@pytest.mark.parametrize("mix", [RESTIR, REFERENCE], ids=["restir",
                                                           "reference"])
def test_a_frame_is_bit_equal_with_spans_on_and_off(corridor, mix):
    off_state, off_img = _frame(corridor["renderer"], corridor["view"], **mix)
    sink = Recorder()
    profiler.enable(sink)
    try:
        on_state, on_img = _frame(corridor["renderer"], corridor["view"],
                                  **mix)
    finally:
        profiler.disable()
    assert sink.spans
    assert torch.equal(on_img, off_img)
    for a, b in zip(_leaves(on_state), _leaves(off_state), strict=True):
        assert torch.equal(a, b)


def test_the_span_tree_of_a_frame(corridor, tracing):
    _frame(corridor["overflowing"], corridor["view"], **RESTIR)
    spans = tracing.spans
    names = set(tracing.names())
    assert {"pass.gbuffer", "pass.bridge", "pass.di", "pass.gi.brdf_rays",
            "pass.gi.shade_secondary", "pass.gi.final", "pass.post",
            "trace.closest", "trace.prep", "trace.walk", "trace.decode",
            "trace.fallback", "readback.overflow_count",
            "readback.overflow_rays"} <= names
    # temporal and spatial GI resampling are off in this mix
    assert not names & {"pass.gi.temporal", "pass.gi.spatial"}
    passes = [s for s in spans if s[0].startswith("pass.")]
    assert all(_parent(spans, s) is None for s in passes)
    closest = [s for s in spans if s[0] == "trace.closest"]
    assert _parent(spans, closest[0]) == "pass.gbuffer"
    assert {_parent(spans, s) for s in closest} <= {
        "pass.gbuffer", "pass.di", "pass.gi.brdf_rays",
        "pass.gi.shade_secondary"}
    for s in spans:
        if s[0] in ("trace.prep", "trace.walk", "trace.decode"):
            assert _parent(spans, s) in ("trace.closest", "trace.occluded",
                                         "trace.fallback")
        if s[0] in ("trace.fallback", "readback.overflow_count"):
            assert _parent(spans, s) in ("trace.closest", "trace.occluded",
                                         "trace.fallback")
        if s[0] == "readback.overflow_rays":
            assert _parent(spans, s) == "trace.fallback"
    # a re-trace's own parts nest inside the fallback, under no other trace
    fallbacks = [s for s in spans if s[0] == "trace.fallback"]
    for fb in fallbacks:
        inner = [s[0] for s in spans if s is not fb and _inside(s, fb)]
        assert {"trace.prep", "trace.walk", "trace.decode",
                "readback.overflow_rays"} <= set(inner)
        assert "trace.closest" not in inner and "trace.fallback" not in inner


def test_readbacks_are_the_trace_calls_plus_two_a_fallback(
        corridor, tracing, monkeypatch):
    """Each bundle-walk trace call (a fallback's re-trace included) reads
    its overflow count; each partial fallback reads its bundles and its
    rows."""
    calls = []
    for name in ("closest_hit_bundle", "occluded_bundle"):
        real = getattr(ct, name)

        def counted(*args, _real=real, **kwargs):
            calls.append(_real)
            return _real(*args, **kwargs)

        monkeypatch.setattr(ct, name, counted)
    before = profiler.counters()
    _frame(corridor["overflowing"], corridor["view"], **RESTIR)
    # the DI validation mix's final visibility adds any-hit traces
    renderer = corridor["overflowing"]
    g = _mix_gconst("di-vis", corridor["view"],
                    renderer.scene_lights.num_local_lights)
    fr.render_frame(renderer, g, fr.init_frame_state(
        W, H, device=torch.device("cpu")))
    after = profiler.counters()
    assert "trace.occluded" in tracing.names()
    fallbacks = tracing.names().count("trace.fallback")
    assert fallbacks >= 1 and len(calls) >= 4
    assert after["readback"] - before.get("readback", 0) == \
        len(calls) + 2 * fallbacks
    assert after["readback.overflow_rays"] - before.get(
        "readback.overflow_rays", 0) == 2 * fallbacks
    total = sum(n for name, n in tracing.counts if name == "readback")
    assert total == len(calls) + 2 * fallbacks
    assert tracing.names().count("readback.overflow_count") == len(calls)


def test_profiler_events_carry_the_prefix(corridor):
    sink = Recorder()
    profiler.enable(sink, prefix="rt2test:")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _frame(corridor["renderer"], corridor["view"], **RESTIR)
    finally:
        profiler.disable()
    events = {e.name for e in prof.events()}
    for name in set(sink.names()):
        assert "rt2test:" + name in events
    assert not any(e.startswith("rt2:") for e in events)


# ---------------------------------------------------------------------------
# On the card: every synchronising call is a counted read
# ---------------------------------------------------------------------------

CARD_CELLS = {
    "restir": ("corridor", dict(segments=4, pillars_per_side=4, lat=12,
                                lon=16), (0.0, 4.0, 15.0), (0.0, 0.0, 1.0)),
    "di-vis": ("emissive", dict(num_lights=64), (0.0, 10.0, -52.0),
               (0.0, 0.25, -1.0)),
    "refmode": ("corridor", dict(segments=4, pillars_per_side=4, lat=12,
                                 lon=16), (0.0, 4.0, 15.0), (0.0, 0.0, 1.0)),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk and cull kernels have no "
                    "CPU mode, and the sync debug mode is CUDA's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(CARD_CELLS))
def test_every_sync_is_a_counted_read_on_card(card, mix, tmp_path_factory):
    kind, args, position, direction = CARD_CELLS[mix]
    glb = (procedural.corridor_glb(**args) if kind == "corridor"
           else procedural.emissive_stress_glb(**args))
    scene = _scene(tmp_path_factory, card, glb)
    w, h = 480, 270
    renderer = fr.create_renderer(scene, w, h)
    g = _mix_gconst(mix, _view(w, h, position, direction),
                    renderer.scene_lights.num_local_lights)
    state = fr.init_frame_state(w, h, device=card)
    state, _ = fr.render_frame(renderer, g, state)  # warm-up
    torch.cuda.synchronize()

    sink, syncs = Recorder(), []
    shown = warnings.showwarning

    def seen(message, category, *rest, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            port = [f for f in traceback.extract_stack()
                    if "raytracer2_tpu_torch" in f.filename]
            syncs.append((time.perf_counter(),
                          f"{port[-1].filename}:{port[-1].lineno}"
                          if port else "outside the port"))
        else:
            shown(message, category, *rest, **kwargs)

    profiler.enable(sink)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fr.render_frame(renderer, g, state)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        profiler.disable()
    reads = [s for s in sink.spans if s[0].startswith("readback.")]
    outside = [line for t, line in syncs
               if not any(a <= t <= b for _, a, b in reads)]
    assert reads and syncs
    assert not outside, sorted(set(outside))
