#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the GPU:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <a> <b> ...

In one process (one set-up, the cell's own sizes and load): for each seed,
the mix's warm-up frames and a window of --seconds, then every compared
number twice, once of the program and once of the control (the plain
reference computed in bfloat16, check.CONTROL_DTYPE, in the program's
place). Prints one JSON line a seed, then each number's lower reading (the
most the program read) and upper reading (the least the control read).
The benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402


def calibrate(cell, seeds, seconds: float, device, t0: float) -> dict:
    """{"seeds": [...], "program": {name: [values]}, "control": {...}}."""
    setup_run = harness.Run(cell, device, seeds[0], False)
    renderer, glb = harness.setup(setup_run, t0)
    out = {"seeds": [], "program": {}, "control": {}}
    for seed in seeds:
        run = harness.Run(cell, device, seed & harness.M32, False)
        run.renderer = renderer
        sampler = check.Sampler(run, cell.mix["checks"], seed)
        sampler.install()
        state = harness.warmup(run, renderer)
        state, prior, img, g, pose, frame = harness.window(
            run, renderer, state, seconds)
        run.unwrap_all()
        ev = sampler.evidence(state, prior, img, g, pose, frame)
        del state, prior, img, g
        prog = check.numbers(ev, glb, cell, device)
        ctrl = check.numbers(ev, glb, cell, device, control=True)
        print(json.dumps({"seed": seed, "frames": run.frames,
                          "program": prog, "control": ctrl}), flush=True)
        out["seeds"].append(seed)
        for side, nums in (("program", prog), ("control", ctrl)):
            for k, v in nums.items():
                out[side].setdefault(k, []).append(v)
    return out


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, harness.load_spec())
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    res = calibrate(cell, args.seeds, args.seconds, torch.device("cuda", 0),
                    T0)
    summary = {k: {"lower": max(v), "upper": min(res["control"][k])}
               for k, v in res["program"].items()}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
