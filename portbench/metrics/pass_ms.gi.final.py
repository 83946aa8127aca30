"""pass_ms.gi.final: device ms between the CUDA events of the program's
pass.gi.final span (render/gi_passes.py::gi_final_shading_pass: the GI
reservoirs' final shading), a window frame."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.gi.final")
