"""pass_ms.di.temporal: device ms between the CUDA events of the
program's pass.di.temporal span (render/di_passes.py::_di_fused_body:
the DI temporal resampling stage and the boiling filter after it), a
window frame. None where the program has no such span (a tree before
it)."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.di.temporal")
