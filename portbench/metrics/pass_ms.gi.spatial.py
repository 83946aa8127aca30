"""pass_ms.gi.spatial: device ms between the CUDA events of the
program's pass.gi.spatial span (render/gi_passes.py::gi_spatial_pass:
the GI reservoirs' spatial resampling over this frame's neighbours), a
window frame."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.gi.spatial")
