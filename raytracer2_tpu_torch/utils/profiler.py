"""Per-pass timing, spans and counters inside a frame, and the ray budget
of a frame; port of raytracer2_tpu/utils/profiler.py.

Strictly more than the reference ships (SURVEY.md §5: an FPS counter and a
frame-budget log line, main.rs:526-533, 653-656): named pass timers with
p50/p95, counters (rays traced) and the rays a frame traces.

Two ways to time, on one clock with the device trace:

- PassTimer.time(name) synchronises the device at both ends of its body
  (torch returns before the card finishes). It suits a whole frame's wall
  time, as the app takes it; inside a frame it would stall the very
  pipelining it measures.
- span(name) never synchronises. The program's layers open spans around
  each pass, each part of a trace and each host read-back; they cost one
  flag test until enable(sink) turns them on. Then each span is a
  torch.profiler.record_function annotation named prefix + name (so it
  shows in a profiler's trace over the kernels launched inside it), and at
  its exit the sink gets the span's host perf_counter interval and, once
  CUDA is initialised, a pair of CUDA events recorded on the current
  stream at its ends. count(name, n) keeps process-wide integer counters
  (counters()), and hands each count to the sink too while one is on.

A sink is any object with span(name, host_t0, host_t1, ev0, ev1) (ev0 and
ev1 None without CUDA) and count(name, n); PassTimer is one.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import numpy as np
import torch

DEFAULT_PREFIX = "rt2:"

_OFF = contextlib.nullcontext()  # the span of every name while tracing is off
_sink = None
_prefix = DEFAULT_PREFIX
_counters: dict[str, int] = defaultdict(int)


def enable(sink, prefix: str = DEFAULT_PREFIX) -> None:
    """Turn the spans on, process-wide, with `sink` receiving each span and
    count; `prefix` starts every annotation's name."""
    global _sink, _prefix
    _sink, _prefix = sink, prefix


def disable() -> None:
    """Turn the spans off: span() is a no-op again; counters stay kept."""
    global _sink
    _sink = None


def counters() -> dict[str, int]:
    """A copy of every count() total since the process started."""
    return dict(_counters)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (and hand it to the sink, if on)."""
    _counters[name] += n
    if _sink is not None:
        _sink.count(name, n)


class _Span:
    __slots__ = ("name", "sink", "note", "t0", "ev0")

    def __init__(self, name: str, sink):
        self.name, self.sink = name, sink

    def __enter__(self):
        self.note = torch.profiler.record_function(_prefix + self.name)
        self.note.__enter__()
        self.ev0 = None
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        self.note.__exit__(*exc)
        self.sink.span(self.name, self.t0, t1, self.ev0, ev1)
        return False


def span(name: str):
    """Context manager over one part of a frame: a shared no-op while
    tracing is off, else an annotated, event-bounded span (module
    docstring)."""
    if _sink is None:
        return _OFF
    return _Span(name, _sink)


class PassTimer:
    """Seconds per named pass across frames, on `device`: `samples` maps
    each name to its list of timed runs, `counters` each counted name to
    its total.

    time(name) times a body between two synchronisations (the app's
    whole-frame time). As the sink of enable(timer), the timer also takes
    the program's spans, which never synchronise: a span's sample is its
    device time between its CUDA events (its host interval without CUDA),
    read once summary() has waited for it; and the counts of count()."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.counters: dict[str, int] = defaultdict(int)
        self._pending: list = []  # (name, ev0, ev1) not yet read

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def time(self, name: str):
        """Context manager: the wall time of its body, with the device's
        queued work finished at both ends. For a whole frame; inside one,
        use span() with this timer as the sink."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.samples[name].append(time.perf_counter() - t0)

    def span(self, name: str, host_t0: float, host_t1: float, ev0=None,
             ev1=None) -> None:
        """The sink's span: one sample of `name`."""
        if ev0 is None:
            self.samples[name].append(host_t1 - host_t0)
        else:
            self._pending.append((name, ev0, ev1))

    def count(self, name: str, n: int) -> None:
        """Accumulate a counter (e.g. rays traced)."""
        self.counters[name] += int(n)

    def summary(self) -> dict:
        """Per timed name its calls, total, p50 and p95 in ms; per counter
        its count and, when anything was timed, its rate over the total
        timed seconds (the JAX package's JSON)."""
        for name, ev0, ev1 in self._pending:
            ev1.synchronize()
            self.samples[name].append(ev0.elapsed_time(ev1) * 1e-3)
        self._pending.clear()
        out = {}
        total = 0.0
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            total += float(arr.sum())
            out[name] = {
                "calls": len(xs),
                "total_ms": round(float(arr.sum()) * 1000, 2),
                "p50_ms": round(float(np.percentile(arr, 50)) * 1000, 2),
                "p95_ms": round(float(np.percentile(arr, 95)) * 1000, 2),
            }
        for name, n in self.counters.items():
            entry = {"count": n}
            if total > 0:
                entry["per_sec"] = round(n / total, 1)
            out[name] = entry
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


def count_frame_rays(g_const, width: int, height: int) -> int:
    """Estimate rays traced per frame for the active pass configuration
    (the reference's implicit ray budget, SURVEY.md §6)."""
    from raytracer2_tpu_torch.render.reference import MAX_BOUNCES, MAX_SAMPLES

    n = width * height
    rays = n  # primary G-buffer (always full-res)
    if g_const.refrence_mode:
        return n * MAX_BOUNCES * MAX_SAMPLES
    # checkerboard rendering launches the lighting passes on the active
    # half-field only (RtxdiHelpers.hlsli:16-61)
    if g_const.runtime_params.active_checkerboard_field != 0:
        n = n // 2
    if g_const.enable_restir_di:
        isp = g_const.restir_di.initial_sampling_params
        rays += n * isp.num_primary_brdf_samples  # BRDF candidate rays
        if isp.enable_initial_visibility:
            rays += n
        if g_const.restir_di.shading_params.enable_final_visibility:
            rays += n
    if g_const.enable_restir_gi:
        rays += n  # bounce rays
        rays += n  # secondary DI brdf candidates
        if g_const.restir_gi.final_shading_params.enable_final_visibility:
            rays += n
        gi_t = g_const.restir_gi.temporal_resampling_params
        if (g_const.enable_temporal_resampling
                and gi_t.temporal_bias_correction_mode == 3):
            rays += n
    return rays
