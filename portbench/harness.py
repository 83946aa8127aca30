"""One run of one benchmark cell of raytracer2_tpu_torch.

A cell (an entry of BENCHMARK.json's workloads) is a configuration
(configs/<config>.json: the scene generator and its arguments, the
resolution, the tracer backend, the camera) under a traffic mix
(traffic/<mix>.json: the GConst a frame gets, the camera's motion, the
warm-up frames, the profiled frames and what the check compares). Every
metric is a reader in metrics/<name>.py; each cell's correctness limits
are limits/<cell>.json. Nothing here names a cell, a mix or a metric: a
new one is new files and new entries.

A run: set-up (the program's kernel library, the scene written as GLB
bytes and loaded through the program's glTF import, build_scene,
create_renderer, the warm-up frames), then frames back to back, one in
flight, each ending in torch.cuda.synchronize(), until --seconds have
passed and a frame has ended; then the check against the plain reference
(check.py), once the device peak has been read and the program's state
freed. With --trace 1 the readers' spans (CUDA events around calls into
the program's layers) are recorded and torch.profiler covers the mix's
profiled frames.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from portbench import check, stats
from portbench.check import OWN_PREFIX

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
M32 = 0xFFFFFFFF
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer2_tpu")
SPAN_PREFIX = "portbench:"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# What a cell is, found by name
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    metrics_e2e: list  # BENCHMARK.json entries
    metrics_layer: list
    limits: dict


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, spec: dict, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, with its configuration, mix and
    limits read from their files under `root`."""
    bench = root / BENCH.name
    work = [w for w in spec["workloads"] if w["name"] == name]
    if not work:
        raise SystemExit(f"portbench: no workload named {name!r} in "
                         "BENCHMARK.json")
    w = work[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
        metrics_e2e=e2e, metrics_layer=layer,
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()))


def load_reader(name: str, root: Path = ROOT):
    """metrics/<name>.py as a module (a name may hold dots)."""
    path = root / BENCH.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The traffic: poses and GConst
# ---------------------------------------------------------------------------

def pose_at(config: dict, mix: dict, seconds: float) -> dict:
    """The camera at `seconds` into the window: the configuration's pose
    moved at the mix's velocity (scene units per second)."""
    cam = config["camera"]
    vel = mix.get("camera_velocity", [0.0, 0.0, 0.0])
    pos = [p + v * seconds for p, v in zip(cam["position"], vel)]
    return {"position": pos, "direction": list(cam["direction"])}


def _replace_path(obj, path: list[str], value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    inner = _replace_path(getattr(obj, path[0]), path[1:], value)
    return dataclasses.replace(obj, **{path[0]: inner})


def make_gconst(mix: dict, view, prev_view, num_lights: int, frame: int,
                accumulated: int = 1):
    """default_gconst with the mix's settings; a dotted key sets a field of
    a nested group (restir_di.shading_params.enable_final_visibility).
    A mix with "running_mean" blends each frame into the lighting with the
    factor 1 / `accumulated` (the frames accumulated, this one included),
    as the app does while it accumulates (main.rs:629-635)."""
    from raytracer2_tpu_torch.params import default_gconst

    flat = {k: v for k, v in mix["gconst"].items() if "." not in k}
    if mix.get("running_mean"):
        flat["blend_factor"] = float(np.float32(1.0 / accumulated))
    g = default_gconst(view, num_lights, **flat)
    for key, value in mix["gconst"].items():
        if "." in key:
            g = _replace_path(g, key.split("."), value)
    return g.replace(prev_view=prev_view, frame=frame & M32)


def view_of(pose: dict, width: int, height: int):
    from raytracer2_tpu_torch.scene.camera import default_camera

    return default_camera(window_size=(width, height),
                          position=tuple(pose["position"]),
                          direction=tuple(pose["direction"])
                          ).planar_view_constants()


# ---------------------------------------------------------------------------
# Hooks: spans, observed calls, the correctness sample
# ---------------------------------------------------------------------------

class Run:
    """What one run records, and the hooks that record it. `frame` is the
    window frame being rendered (-1 in set-up and after the window)."""

    def __init__(self, cell: Cell, device: torch.device, seed: int,
                 trace: bool):
        self.cell, self.device, self.seed, self.trace = cell, device, seed, trace
        self.frame = -1
        self.frames = 0
        self.profiling = False  # the frame being rendered is profiled
        self.accumulated = 0  # frames rendered since the first warm-up
        self.frame_s: list[float] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.setup_parts: dict[str, float] = {}
        self.renderer = None
        self.spans = defaultdict(list)  # name -> [(frame, start, end)]
        self.observed = defaultdict(list)  # name -> [(frame, value)]
        self.counters: dict[str, float] = {}
        self.missing: set[str] = set()
        self.profiled: range = range(0)
        self.profile: dict | None = None
        self._restore: list = []

    # -- targets -----------------------------------------------------------
    def _resolve(self, target: str):
        owner_name, _, attr = target.partition(":")
        if owner_name == "tracers":
            owner = self.renderer.tracers
        else:
            try:
                owner = importlib.import_module(owner_name)
            except ImportError:
                return None
        return (owner, attr) if callable(getattr(owner, attr, None)) else None

    def wrap(self, target: str, make) -> bool:
        """Replace the callable `target` ("module:attr", or "tracers:attr"
        for the renderer's tracers) by make(original); False, and nothing
        done, where it does not exist."""
        found = self._resolve(target)
        if found is None:
            return False
        owner, attr = found
        inner = getattr(owner, attr)
        # the wrapper carries the function's attributes (the program counts
        # launches on its wrappers' function objects)
        setattr(owner, attr, functools.update_wrapper(make(inner), inner))
        self._restore.append((owner, attr, inner))
        return True

    def unwrap_all(self) -> None:
        for owner, attr, inner in reversed(self._restore):
            setattr(owner, attr, inner)
        self._restore.clear()

    def _stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def span(self, name: str, *targets: str) -> bool:
        """Time every call of the targets as span `name` (CUDA events, no
        synchronisation), inside a profiler annotation of that name. False
        where a target is gone: its readers then report nothing."""
        run = self

        def make(inner):
            def timed(*args, **kwargs):
                if run.frame < 0:
                    return inner(*args, **kwargs)
                t0 = run._stamp()
                with torch.profiler.record_function(SPAN_PREFIX + name):
                    out = inner(*args, **kwargs)
                run.spans[name].append((run.frame, t0, run._stamp()))
                return out
            return timed

        ok = all([self.wrap(t, make) for t in targets])
        if not ok:
            self.missing.add(name)
        return ok

    def observe(self, name: str, target: str, fn) -> bool:
        """Keep fn(args, kwargs, out) of every window call of the target;
        fn's device work is the benchmark's own (OWN_PREFIX)."""
        run = self

        def make(inner):
            def seen(*args, **kwargs):
                out = inner(*args, **kwargs)
                if run.frame >= 0:
                    with torch.profiler.record_function(OWN_PREFIX + name):
                        value = fn(args, kwargs, out)
                    run.observed[name].append((run.frame, value))
                return out
            return seen

        if not self.wrap(target, make):
            self.missing.add(name)
            return False
        return True

    # -- readings ------------------------------------------------------------
    def span_ms_per_frame(self, name: str) -> float | None:
        if name in self.missing or not self.spans.get(name):
            return None
        total = 0.0
        for _, a, b in self.spans[name]:
            total += (a.elapsed_time(b) if self.device.type == "cuda"
                      else (b - a) * 1e3)
        return total / self.frames


# ---------------------------------------------------------------------------
# The profiler
# ---------------------------------------------------------------------------

def _read_profile(prof) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    return read_events([(e.name(), e.device_type() == cuda, e.start_ns(),
                         e.end_ns())
                        for e in prof.profiler.kineto_results.events()])


def read_events(events) -> dict:
    """The program's kernels and the host's span annotations of a profile's
    events (name, on the device, start, end), in ns on one clock:
    {"kernels": [(name, start, end)], "annotations": [...], "own": n}.
    An annotation also shows on the device's timeline, over the kernels
    launched inside it: it is no operation of the device, and the kernels
    inside an OWN_PREFIX one are the benchmark's own ("own" counts them)."""
    kernels, notes, own = [], [], []
    for name, on_device, a, b in events:
        if name.startswith(OWN_PREFIX):
            if on_device:
                own.append((a, b))
        elif name.startswith(SPAN_PREFIX):
            if not on_device:
                notes.append((name[len(SPAN_PREFIX):], a, b))
        elif on_device:
            kernels.append((name, a, b))
    own.sort()
    starts = [a for a, _ in own]

    def inside(a, b):
        i = bisect.bisect_right(starts, a) - 1
        return i >= 0 and b <= own[i][1]

    program = [k for k in kernels if not inside(k[1], k[2])]
    return {"kernels": program, "annotations": notes,
            "own": len(kernels) - len(program)}


def breakdown(profile: dict, top: int = 10) -> dict:
    """The device operations that took most time, by kernel name, and the
    longest idle gaps summed by the innermost span the host was in."""
    by_op = defaultdict(float)
    for name, a, b in profile["kernels"]:
        by_op[name] += (b - a) * 1e-9
    gaps = stats.idle_gaps([(a, b) for _, a, b in profile["kernels"]])
    notes = sorted(profile["annotations"], key=lambda x: x[1])
    by_span = defaultdict(float)
    for g0, g1 in gaps:
        inside = [n for n in notes if n[1] <= g0 < n[2]]
        name = (min(inside, key=lambda n: n[2] - n[1])[0] if inside
                else "outside_frames")
        by_span[name] += (g1 - g0) * 1e-9
    return {
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_span.items()),
                            key=lambda x: -x[1])[:top]}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def smi_start() -> subprocess.Popen | None:
    """nvidia-smi's line on the card (name, power limit, clocks, power,
    temperature), started beside the set-up: read it with smi_read()."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def smi_read(proc: subprocess.Popen | None) -> str:
    if proc is None:
        return "nvidia-smi unavailable"
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return "nvidia-smi timed out"
    return out.strip().replace("\n", " | ")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(run: Run, t0: float):
    """The program's library, the scene and the renderer; returns
    (renderer, the scene's GLB bytes)."""
    cell, dev = run.cell, run.device
    parts = run.setup_parts

    def mark(name, since):
        parts[name] = time.perf_counter() - since
        return time.perf_counter()

    t = time.perf_counter()
    parts["start"] = t - t0 - sum(parts.values())
    from raytracer2_tpu_torch.render import frame as fr
    from raytracer2_tpu_torch.scene import gltf
    from raytracer2_tpu_torch.scene.scene import build_scene
    t = mark("import", t)
    if dev.type == "cuda":
        from raytracer2_tpu_torch.ops import _build
        built = _build.build()
        _build.library()
        run.counters["compiled"] = float(built.seconds > 0)
    t = mark("library", t)

    from portbench.scenes import GENERATORS
    conf = cell.config
    glb = GENERATORS[conf["generator"]](**conf["args"])
    t = mark("scene_generate", t)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "scene.glb"
        path.write_bytes(glb)
        model = gltf.load_file(path)
    t = mark("gltf_load", t)
    scene = build_scene(model, device=dev)
    sync(dev)
    t = mark("build_scene", t)
    w, h = conf["width"], conf["height"]
    renderer = fr.create_renderer(scene, w, h, backend=conf["backend"])
    sync(dev)
    t = mark("create_renderer", t)
    run.renderer = renderer
    return renderer, glb


def warmup(run: Run, renderer):
    """The mix's warm-up frames at the window's first pose, with the
    hooks already in place; returns the frame state."""
    from raytracer2_tpu_torch.render import frame as fr

    cell, dev = run.cell, run.device
    t = time.perf_counter()
    w, h = cell.config["width"], cell.config["height"]
    state = fr.init_frame_state(w, h, device=dev)
    warm = int(cell.mix["warmup_frames"])
    view = view_of(pose_at(cell.config, cell.mix, 0.0), w, h)
    for i in range(warm):
        run.accumulated += 1
        g = make_gconst(cell.mix, view, view,
                        renderer.scene_lights.num_local_lights,
                        run.seed - 1 - i, run.accumulated)
        state, _ = fr.render_frame(renderer, g, state)
        sync(dev)
    run.setup_parts["warmup"] = time.perf_counter() - t
    return state


def window(run: Run, renderer, state, seconds: float):
    """Frames back to back until `seconds` have passed and a frame has
    ended. Returns (state, the lighting planes the last frame started
    from, image, GConst, pose, frame index) of the last frame."""
    from raytracer2_tpu_torch.render import frame as fr

    cell, dev = run.cell, run.device
    conf, mix = cell.config, cell.mix
    w, h = conf["width"], conf["height"]
    lights = renderer.scene_lights.num_local_lights
    prof_spec = mix.get("profile_frames", {"skip": 1, "count": 1})
    p0, pn = int(prof_spec["skip"]), int(prof_spec["count"])
    prof = None
    prev_view = view_of(pose_at(conf, mix, 0.0), w, h)
    img = pose = g = prior = None
    fallback0 = renderer.tracers.fallback_bundles
    sync(dev)
    start = time.perf_counter()
    k = 0
    while True:
        if run.trace and k == p0:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            prof_t0 = time.perf_counter()
            run.profiling = True
        t0 = time.perf_counter()
        pose = pose_at(conf, mix, t0 - start)
        view = view_of(pose, w, h)
        run.accumulated += 1
        g = make_gconst(mix, view, prev_view, lights, run.seed + k,
                        run.accumulated)
        # the planes the frame starts from (a reference, no copy: a frame
        # never writes its input state)
        prior = (state.diffuse_lighting, state.specular_lighting)
        run.frame = k
        with torch.profiler.record_function(SPAN_PREFIX + "frame"):
            state, img = fr.render_frame(renderer, g, state)
        sync(dev)
        t1 = time.perf_counter()
        run.frame = -1
        run.frame_s.append(t1 - t0)
        prev_view = view
        k += 1
        if prof is not None and k == p0 + pn:
            run.counters["profiled_window_s"] = t1 - prof_t0
            prof.stop()
            run.profiling = False
            run.profile = _read_profile(prof)
            run.profiled = range(p0, p0 + pn)
            log(f"profile kernels {len(run.profile['kernels'])} own "
                f"{run.profile['own']}")
            prof = None
            # reading the profile takes host time: the window's clock
            # leaves it out
            start += time.perf_counter() - t1
            t1 = time.perf_counter()
        if t1 - start >= seconds:
            break
    if prof is not None:  # the window ended inside the profiled frames
        run.counters["profiled_window_s"] = time.perf_counter() - prof_t0
        prof.stop()
        run.profiling = False
        run.profile = _read_profile(prof)
        run.profiled = range(p0, k)
    run.window_s = t1 - start
    run.frames = k
    run.counters["fallback_bundles"] = (renderer.tracers.fallback_bundles
                                        - fallback0)
    return state, prior, img, g, pose, (run.seed + k - 1) & M32


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, control: bool = False,
             early: dict | None = None) -> dict:
    """One run; returns the result line's object (without printing).
    early: set-up parts timed before the call (seconds by name)."""
    run = Run(cell, device, seed & M32, trace)
    run.setup_parts.update(early or {})
    sampler = check.Sampler(run, cell.mix["checks"], seed)
    readers = {m["name"]: load_reader(m["name"])
               for m in (cell.metrics_layer if trace else cell.metrics_e2e)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    renderer, glb = setup(run, t0)
    if trace:
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(run)
    sampler.install()
    state = warmup(run, renderer)
    run.setup_s = time.perf_counter() - t0
    for name, sec in run.setup_parts.items():
        log(f"setup {name} {sec:.4f} s")
    log(f"setup total {run.setup_s:.4f} s first_compile="
        f"{bool(run.counters.get('compiled'))}")

    state, prior, img, g, pose, frame = window(run, renderer, state,
                                               seconds)
    log(window_line(run))
    if device.type == "cuda":
        log(f"smi after {smi_read(smi_start())}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics = {}
    for name, r in readers.items():
        value = r.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": r.UNIT}
    run.unwrap_all()

    evidence = sampler.evidence(state, prior, img, g, pose, frame)
    del renderer, state, prior, img, g
    run.renderer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.numbers(evidence, glb, cell, device, control=control)
    verdict = check.judge(numbers, cell.limits)
    log(f"check {time.perf_counter() - t_check:.4f} s")

    out = {
        "correct": verdict["correct"],
        "attempted": run.frames,
        "failed": 0 if verdict["correct"] else run.frames,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace and run.profile is not None:
        busy = stats.union_busy([(a, b) for _, a, b in
                                 run.profile["kernels"]]) * 1e-9
        out["device"]["busy_s"] = busy
        out["device"]["window_s"] = run.counters["profiled_window_s"]
        out["breakdown"] = breakdown(run.profile)
    out["checks"] = verdict["checks"]
    return out


def window_line(run: Run) -> str:
    """The window's length and frames, and its frame times' spread: the
    least, the median, the most, and the median of each third."""
    ms = [s * 1e3 for s in run.frame_s]
    n = len(ms)
    thirds = [stats.percentile(ms[i * n // 3:(i + 1) * n // 3] or ms, 50)
              for i in range(3)]
    return (f"window {run.window_s:.4f} s frames {run.frames} frame_ms min "
            f"{min(ms):.2f} median {stats.percentile(ms, 50):.2f} max "
            f"{max(ms):.2f} thirds " + " ".join(f"{t:.2f}" for t in thirds))


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str], t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    early = {"python_imports": time.perf_counter() - t0}
    cell = load_cell(args.workload, load_spec())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s);"
              f" torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}. The benchmark "
              "runs on the GPU only.", file=sys.stderr)
        return 2
    smi = smi_start()
    t = time.perf_counter()
    torch.cuda.init()
    early["cuda_init"] = time.perf_counter() - t
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t0, early=early)
    log(f"smi {smi_read(smi)}")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
