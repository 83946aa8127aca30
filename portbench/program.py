"""The program's own spans and counters (raytracer2_tpu_torch.utils.profiler:
span, count, enable), read into a Run by the readers that need them.

install(run) turns them on once a run, with the harness's SPAN_PREFIX
starting every annotation: read_events then files the program's spans as
host spans beside the harness's own (their device-side copies are not
kernels), and breakdown() puts each idle gap down to the innermost of
them. The sink keeps what the window's frames (run.frame >= 0) record:
each span's CUDA events as (frame, ev0, ev1) in run.spans[name] (its host
perf_counter ends where there is no CUDA event), its host interval in
Sink.host[name] in the same order, and each count as (frame, n) in
run.observed[name]. Sink.seen holds every span and counter name the
program gave at any time of the run, set-up included. A program without
the facility (an older tree) leaves install() False and every reading
None.
"""

from __future__ import annotations

from collections import defaultdict

from portbench.harness import SPAN_PREFIX

FALLBACK = "trace.fallback"


class Sink:
    def __init__(self, run):
        self.run = run
        self.host = defaultdict(list)  # name -> [(frame, t0, t1)]
        self.seen: set[str] = set()

    def span(self, name, host_t0, host_t1, ev0, ev1):
        self.seen.add(name)
        frame = self.run.frame
        if frame < 0:
            return
        ends = (ev0, ev1) if ev0 is not None else (host_t0, host_t1)
        self.run.spans[name].append((frame,) + ends)
        self.host[name].append((frame, host_t0, host_t1))

    def count(self, name, n):
        self.seen.add(name)
        if self.run.frame >= 0:
            self.run.observed[name].append((self.run.frame, n))


def install(run) -> bool:
    """Turn the program's spans on for this run (once); False where the
    program has no such facility."""
    if getattr(run, "program_sink", None) is not None:
        return True
    try:
        from raytracer2_tpu_torch.utils import profiler
    except ImportError:
        return False
    if not callable(getattr(profiler, "enable", None)):
        return False
    run.program_sink = Sink(run)
    profiler.enable(run.program_sink, prefix=SPAN_PREFIX)
    return True


def _sink(run):
    return getattr(run, "program_sink", None)


def _ms(run, a, b) -> float:
    return (a.elapsed_time(b) if run.device.type == "cuda"
            else (b - a) * 1e3)


def _inside(outer: list, frame: int, t0: float, t1: float) -> bool:
    return any(f == frame and a <= t0 and t1 <= b for f, a, b in outer)


def span_ms(run, name: str, top_level: bool = False,
            present: str | None = None) -> float | None:
    """Device ms a window frame (CUDA events; host ms without CUDA) inside
    the program's spans `name`; top_level leaves out those inside a
    trace.fallback span (a re-trace's own). None where the program gave no
    such span in the whole run, unless it gave `present` (then 0)."""
    sink = _sink(run)
    if sink is None or not run.frames:
        return None
    if name not in sink.seen and (present is None
                                  or present not in sink.seen):
        return None
    outer = sink.host[FALLBACK] if top_level else []
    total = 0.0
    for (frame, a, b), (_, t0, t1) in zip(run.spans[name], sink.host[name]):
        if not _inside(outer, frame, t0, t1):
            total += _ms(run, a, b)
    return total / run.frames


def host_ms(run, prefix: str) -> float | None:
    """Host-clock ms a window frame inside the program's spans whose name
    starts with `prefix`; None where it gave none in the whole run."""
    sink = _sink(run)
    if (sink is None or not run.frames
            or not any(n.startswith(prefix) for n in sink.seen)):
        return None
    total = sum(t1 - t0 for name, spans in sink.host.items()
                if name.startswith(prefix) for _, t0, t1 in spans)
    return total * 1e3 / run.frames


def count_per_frame(run, name: str) -> float | None:
    """The program's count `name` over the window, a frame; None where it
    never counted it in the whole run."""
    sink = _sink(run)
    if sink is None or not run.frames or name not in sink.seen:
        return None
    return sum(n for _, n in run.observed[name]) / run.frames
