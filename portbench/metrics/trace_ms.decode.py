"""trace_ms.decode: device ms between the CUDA events of the program's
top-level trace.decode spans (ops/cuda_traverse.py: a closest-hit trace's
hit_decode, one launch of csrc/hit_decode.cu on the card that un-sorts the
winners, gathers their triangle rows and re-evaluates t, u, v; an any-hit
trace's un-sort), a window frame. A fallback re-trace's own decode, inside
trace.fallback, is left out."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "trace.decode", top_level=True)
