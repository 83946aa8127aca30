"""trace_ms.fallback: device ms between the CUDA events of the program's
trace.fallback spans (ops/cuda_traverse.py: the overflowed bundles' rows,
their re-trace at full candidate length and the merge), a window frame;
0 in a run whose traces never overflowed."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "trace.fallback", present="trace.prep")
