"""fallback_bundles: bundles whose candidate union overflowed k_cand and
re-traced at full length (the program's Tracers.fallback_by_class,
summed over the window), a frame."""

UNIT = "bundles"


def read(run):
    if "fallback_bundles" not in run.counters or not run.frames:
        return None
    return run.counters["fallback_bundles"] / run.frames
