"""Shared fixtures of the benchmark's CPU tests: the cells of
BENCHMARK.json, and a cell cut to a tiny size (64x32, a 4-segment corridor
or 16 lights, small samples) that runs through the whole harness on the
CPU in seconds."""

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.scenes import GENERATORS  # noqa: E402

# every cell BENCHMARK.json lists: a new cell is a new entry there
CELLS = tuple(w["name"] for w in harness.load_spec()["workloads"])
SEED = 2**31 + 12345  # a seed past 32 signed bits, as the driver draws


def tiny_cell(name: str):
    """The cell with its sizes cut: the scene, the image, the samples, and
    the limits' least counts scaled to what such a run compares."""
    cell = harness.load_cell(name, harness.load_spec())
    cfg = cell.config
    if cfg["generator"] not in GENERATORS:
        raise ValueError(
            f"{name}: no scene generator {cfg['generator']!r} in "
            f"portbench/scenes.py (it has {sorted(GENERATORS)})")
    if cfg["generator"] == "corridor_glb":
        cfg["args"] = dict(segments=4, pillars_per_side=4, lat=12, lon=16)
        cfg["camera"]["position"] = [0.0, 4.0, 15.0]
    else:
        cfg["args"] = dict(num_lights=16)
    cfg["width"], cfg["height"] = 64, 32
    for spec in cell.mix["checks"].values():
        for key in ("rays", "pixels"):
            if key in spec:
                spec[key] = min(spec[key], 256)
        if "samples" in spec:
            spec["pixels"], spec["samples"] = 8, 4
    for lim in cell.limits.values():
        if "min" in lim:
            lim["min"] = min(lim["min"], 8)
    cell.mix["profile_frames"] = {"skip": 0, "count": 1}
    return cell


def run_tiny(cell, seconds: float = 0.5, trace: bool = False,
             control: bool = False) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), control=control)

