"""pass_ms.gi.temporal: device ms between the CUDA events of the
program's pass.gi.temporal span (render/gi_passes.py::gi_temporal_pass:
the GI reservoirs' temporal resampling, its reprojection search over the
previous frame's reservoirs), a window frame."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.gi.temporal")
