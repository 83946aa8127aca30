"""trace_ms.decode: device ms between the CUDA events of the program's
top-level trace.decode spans (ops/cuda_traverse.py: _unsort and _decode,
the winner's re-evaluation in float64-emulated fma), a window frame. A
fallback re-trace's own decode, inside trace.fallback, is left out."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "trace.decode", top_level=True)
