"""walk_ms: device time of the walk kernels B1 (walk_closest_kernel,
csrc/bundle_walk.cu) and B2 (walk_occluded_kernel,
csrc/bundle_occlude.cu) in the profiled frames, ms a frame."""

UNIT = "ms"
KERNELS = ("walk_closest_kernel", "walk_occluded_kernel")


def read(run):
    if not run.profile or not len(run.profiled):
        return None
    ns = [b - a for name, a, b in run.profile["kernels"]
          if any(k in name for k in KERNELS)]
    if not ns:
        return None
    return sum(ns) * 1e-6 / len(run.profiled)
