"""cull_roofline: the cull kernels B3 (nearest_box_kernel) and B4
(bundle_union_kernel, csrc/cull.cu) in the profiled frames: the sum of
each call's bound (stats.cull_bound_s, from the call's own inputs: its
rays, live rays, boxes and output) over the sum of their device time, in
percent of an H100 SXM's data-sheet rates at 700 W."""

from portbench import stats

UNIT = "%"
KERNELS = ("nearest_box_kernel", "bundle_union_kernel")
MODULE = "raytracer2_tpu_torch.ops.cull"


def _shape(args, kwargs, out):
    rays8, amin = args[0], args[1]
    table = out[0] if isinstance(out, tuple) else out
    return (rays8.shape[0], (rays8[:, 7] >= 0.0).sum(), amin.shape[0],
            table.numel())

def install(run):
    run.observe("cull", f"{MODULE}:nearest_box", _shape)
    run.observe("cull", f"{MODULE}:bundle_union", _shape)

def read(run):
    if not run.profile or "cull" in run.missing:
        return None
    ns = sum(b - a for name, a, b in run.profile["kernels"]
             if any(k in name for k in KERNELS))
    calls = [c for f, c in run.observed["cull"] if f in run.profiled]
    if not ns or not calls:
        return None
    bound = sum(stats.cull_bound_s(n, int(live), boxes, out)
                for n, live, boxes, out in calls)
    return 100.0 * bound / (ns * 1e-9)
