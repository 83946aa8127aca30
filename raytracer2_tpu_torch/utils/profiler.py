"""Per-pass timing and the ray budget of a frame, port of
raytracer2_tpu/utils/profiler.py.

Strictly more than the reference ships (SURVEY.md §5: an FPS counter and a
frame-budget log line, main.rs:526-533, 653-656): named pass timers with
p50/p95, counters (rays traced) and the rays a frame traces. Torch returns
before the card finishes, so a timer on a CUDA device synchronises it
around what it times; on the CPU it synchronises nothing.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import numpy as np
import torch

from raytracer2_tpu_torch.render.reference import MAX_BOUNCES, MAX_SAMPLES


class PassTimer:
    """Wall seconds per named pass across frames, on `device`: `samples`
    maps each name to its list of timed runs, `counters` each counted name
    to its total."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.counters: dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def time(self, name: str):
        """Context manager: the wall time of its body, with the device's
        queued work finished at both ends."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.samples[name].append(time.perf_counter() - t0)

    def count(self, name: str, n: int) -> None:
        """Accumulate a counter (e.g. rays traced)."""
        self.counters[name] += int(n)

    def summary(self) -> dict:
        """Per timed name its calls, total, p50 and p95 in ms; per counter
        its count and, when anything was timed, its rate over the total
        timed seconds (the JAX package's JSON)."""
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
