"""trace_ms.prep: device ms between the CUDA events of the program's
top-level trace.prep spans (ops/cuda_traverse.py::_prepare: the sort key
with B3, the sort, the rank, B4, the candidate lists; and the walk's ray
rows), a window frame. A fallback re-trace's own prep, inside
trace.fallback, is left out."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "trace.prep", top_level=True)
