#!/usr/bin/env python3
"""Times the binning scatter (B6, raytracer2_tpu_torch/csrc/binning.cu) of
one tree of the port on the inputs that `chip_smoke.py --dump-bin DIR` saved
(the first binning of each pairs trace, and the probe's ids), so that two
trees can be compared on the same card and the same ids:

    PYTHONPATH=<tree> python3 tools/bin_scatter_ab.py --ids DIR --label NAME

The tree first on PYTHONPATH is the one measured (the script imports
raytracer2_tpu_torch from there and builds its kernels there). Run two trees
in turn on one card, in one run (parent, change, change, parent), to
compare them. For each input it first holds the kernel's output to the
tree's plain version, then times it four ways:

- call_ms: CUDA events around one call of the wrapper, its host time to
  the launches included (chip_smoke.py times every kernel so);
- graph_ms: one replay of the call captured in a CUDA graph, the L2 written
  over before it, so the card's time alone, with the ids read from HBM;
- kernels_us: each CUDA kernel of the call, its mean device time under
  torch.profiler (count, scan, scatter, and any fill the wrapper launches);
- argsort_ms, argsort_graph_ms: torch.argsort(stable=True) on the same ids,
  the library call that computes the same order, both ways.

It prints one JSON line per input, then the card's name and power limit.
Needs a CUDA card; writes nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# written over before each timed replay: four times the 50 MB L2 of an H100
L2_FLUSH_BYTES = 200 << 20
# the sentinel the graph's outputs hold before the checked replay
SENTINEL = 0x5EEDBEEF


def _outputs(out) -> list:
    """The tensors of a call's result (a tensor or a tuple of them)."""
    if torch.is_tensor(out):
        return [out]
    return [x for x in out if torch.is_tensor(x)]


def graph_ms(fn, want, reps: int = 20) -> float:
    """The card's time of one call of fn, in ms: fn captured once in a CUDA
    graph (after a warm-up call), then the median over reps replays, each
    timed alone by CUDA events after L2_FLUSH_BYTES were written (so its
    inputs come from HBM). Before the last replay every output of the graph
    is set to SENTINEL; after it the outputs must equal `want` (a tensor or
    a tuple of them, None where fn returns None), so a graph that launched
    nothing, or wrote part of its outputs, raises. Raises on a time <= 0."""
    fn()  # warm-up: builds the kernels, fills the allocator's cache
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    dev = _outputs(out)[0].device
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    for x in _outputs(out):
        x.fill_(SENTINEL)
    graph.replay()
    torch.cuda.synchronize()
    got, wanted = _outputs(out), _outputs(want)
    if len(got) != len(wanted) or any(
            g.shape != w.shape or not torch.equal(g, w.to(g.device))
            for g, w in zip(got, wanted)):
        raise RuntimeError("the graph's replay does not give the call's "
                           "result")
    ms = statistics.median(times)
    if not ms > 0:
        raise RuntimeError(f"a graph replay timed {ms} ms")
    return ms


def call_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call of fn in ms, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _kernel_name(key: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    arguments: 'void (anonymous namespace)::scatter_kernel(int const*, ...)'
    gives 'scatter_kernel'."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in "(<":
        name = name.split(stop)[0]
    return name.split("::")[-1].strip()


def kernels_us(fn, calls: int = 10) -> dict:
    """{kernel name: mean device time in us} of the kernels fn launches,
    from torch.profiler over `calls` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
            continue
        name = _kernel_name(e.key)
        out[name] = out.get(name, 0.0) + e.device_time_total / e.count
    if not out:
        raise RuntimeError("the profiler saw no kernel")
    return {name: round(us, 3) for name, us in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ids", required=True, type=Path,
                    help="a directory of chip_smoke.py --dump-bin inputs")
    ap.add_argument("--label", required=True, help="the tree's name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bin_scatter_ab: needs a CUDA device")
    import raytracer2_tpu_torch
    from raytracer2_tpu_torch.ops import binning

    files = sorted(args.ids.glob("*.pt"))
    if not files:
        sys.exit(f"bin_scatter_ab: no inputs in {args.ids}")
    dev = torch.device("cuda")
    for f in files:
        case = torch.load(f)
        ids, n_bins, kw = case["ids"].to(dev), case["n_bins"], case["kwargs"]
        got = binning.bin_scatter(ids, n_bins, **kw)
        want = binning.bin_scatter_reference(ids, n_bins, **kw)
        if any(w is not None and not torch.equal(g, w)
               for g, w in zip(got, want)):
            raise RuntimeError(f"{case['cls']}: kernel and plain differ")
        order = torch.argsort(ids, stable=True)
        row = {
            "label": args.label, "cls": case["cls"], "ids": ids.numel(),
            "bins": n_bins,
            "call_ms": call_ms(lambda: binning.bin_scatter(ids, n_bins,
                                                           **kw)),
            "graph_ms": graph_ms(
                lambda: binning.bin_scatter(ids, n_bins, **kw), want),
            "kernels_us": kernels_us(
                lambda: binning.bin_scatter(ids, n_bins, **kw)),
            "argsort_ms": call_ms(lambda: torch.argsort(ids, stable=True)),
            "argsort_graph_ms": graph_ms(
                lambda: torch.argsort(ids, stable=True), order),
            "package": str(Path(raytracer2_tpu_torch.__file__).parent)}
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available")


if __name__ == "__main__":
    main()
