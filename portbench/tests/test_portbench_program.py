"""The readers of the program's own spans and counters (portbench/program.py
and its eight metrics) on synthetic runs: units, None where the program
gave no such span (or has no span facility at all), only the window's
frames counted, a fallback's re-trace left out of the top-level trace
spans; and one tiny traced run on the CPU that reports all eight."""

import pytest
import torch

from portbench import harness, program
from raytracer2_tpu_torch.utils import profiler

from .conftest import run_tiny, tiny_cell

SPAN_METRICS = {
    "trace_ms.prep": "trace.prep", "trace_ms.decode": "trace.decode",
    "trace_ms.fallback": "trace.fallback",
    "pass_ms.gi.brdf_rays": "pass.gi.brdf_rays",
    "pass_ms.gi.shade_secondary": "pass.gi.shade_secondary",
    "pass_ms.gi.final": "pass.gi.final"}
NEW = sorted(SPAN_METRICS) + ["readback_wait_ms", "readbacks_per_frame"]


@pytest.fixture
def run():
    r = harness.Run(None, torch.device("cpu"), 1, True)
    yield r
    profiler.disable()


def _installed(run):
    for name in NEW:
        harness.load_reader(name).install(run)
    assert run.program_sink is not None
    return run.program_sink


def _span(sink, frame, name, t0, t1):
    sink.run.frame = frame
    sink.span(name, t0, t1, None, None)


def test_units_match_the_benchmark():
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for name in NEW:
        assert harness.load_reader(name).UNIT == spec[name]["unit"]
        assert spec[name]["moves"] == "frame_ms"


def test_install_turns_the_program_spans_on_once(run):
    sink = _installed(run)
    assert profiler.span("trace.walk") is not profiler.span("trace.walk")
    with profiler.span("pass.gbuffer"):
        pass
    assert sink.seen == {"pass.gbuffer"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("trace.walk"):
            torch.ones(2).sum()
    assert harness.SPAN_PREFIX + "trace.walk" in {
        e.name for e in prof.events()}


def test_nothing_to_read_is_none(run, monkeypatch):
    run.frames = 3
    for name in NEW:  # never installed
        assert harness.load_reader(name).read(run) is None
    # a program without the facility (an older tree): install is False
    monkeypatch.delattr(profiler, "enable")
    assert program.install(run) is False
    for name in NEW:
        assert harness.load_reader(name).read(run) is None


def test_spans_the_program_never_gave_are_none(run):
    sink = _installed(run)
    run.frames = 2
    _span(sink, 0, "pass.gbuffer", 0.0, 1.0)
    for name in NEW:
        assert harness.load_reader(name).read(run) is None
    # with the trace layer's spans there, a run without a fallback reads 0
    _span(sink, 0, "trace.prep", 0.0, 0.5)
    assert harness.load_reader("trace_ms.fallback").read(run) == 0.0


def test_window_frames_only_and_their_units(run):
    sink = _installed(run)
    run.frames = 2
    # set-up (frame -1) is left out
    _span(sink, -1, "trace.prep", 0.0, 9.0)
    sink.count("readback", 5)
    _span(sink, 0, "trace.prep", 10.0, 10.004)
    _span(sink, 1, "trace.prep", 20.0, 20.002)
    for k, name in enumerate(SPAN_METRICS.values()):
        _span(sink, 1, name, 30.0 + k, 30.010 + k)
    _span(sink, 0, "readback.overflow_count", 40.0, 40.003)
    _span(sink, 1, "readback.overflow_rays", 41.0, 41.001)
    run.frame = 0
    sink.count("readback", 3)
    run.frame = 1
    sink.count("readback", 4)
    read = {name: harness.load_reader(name).read(run) for name in NEW}
    assert read["trace_ms.prep"] == pytest.approx((4 + 2 + 10) / 2)
    for metric, name in SPAN_METRICS.items():
        if metric != "trace_ms.prep":
            assert read[metric] == pytest.approx(10 / 2)
    assert read["readback_wait_ms"] == pytest.approx((3 + 1) / 2)
    assert read["readbacks_per_frame"] == pytest.approx((3 + 4) / 2)


def test_a_retraces_spans_are_not_top_level(run):
    sink = _installed(run)
    run.frames = 1
    # the outer trace's prep, then a fallback holding its re-trace's own
    _span(sink, 0, "trace.prep", 1.0, 1.003)
    _span(sink, 0, "trace.decode", 1.004, 1.005)
    _span(sink, 0, "trace.prep", 1.010, 1.012)
    _span(sink, 0, "trace.decode", 1.013, 1.014)
    _span(sink, 0, "trace.fallback", 1.008, 1.020)
    # the same times in another frame's fallback do not hide this one's
    _span(sink, 1, "trace.fallback", 0.0, 2.0)
    run.frames = 2
    assert harness.load_reader("trace_ms.prep").read(run) == \
        pytest.approx(3 / 2)
    assert harness.load_reader("trace_ms.decode").read(run) == \
        pytest.approx(1 / 2)
    assert harness.load_reader("trace_ms.fallback").read(run) == \
        pytest.approx((12 + 2000) / 2)


def test_a_tiny_traced_run_reports_them():
    cell = tiny_cell("ladder-1080p.restir")
    cell.mix["profile_frames"] = {"skip": 1, "count": 1}
    try:
        out = run_tiny(cell, seconds=2.0, trace=True)
    finally:
        profiler.disable()
    for name in NEW:
        assert name in out["metrics"], name
        assert out["metrics"][name]["value"] >= 0.0
    assert out["metrics"]["readbacks_per_frame"]["value"] >= 3
