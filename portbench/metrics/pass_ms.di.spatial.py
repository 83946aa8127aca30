"""pass_ms.di.spatial: device ms between the CUDA events of the
program's pass.di.spatial span (render/di_passes.py::_di_fused_body: the
DI spatial resampling stage, its neighbours and pairwise MIS), a window
frame. None where the program has no such span (a tree before it)."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.di.spatial")
