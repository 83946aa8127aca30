"""trace_ms: device time between CUDA events around each call of the
renderer's tracers (Tracers.closest_hit and Tracers.occluded: the sort,
the cull, the walk and the decode of ops/cuda_traverse.py), ms a window
frame."""

UNIT = "ms"
SPAN = "trace"


def install(run):
    run.span(SPAN, "tracers:closest_hit", "tracers:occluded")


def read(run):
    return run.span_ms_per_frame(SPAN)
