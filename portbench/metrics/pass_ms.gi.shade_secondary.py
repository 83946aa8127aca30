"""pass_ms.gi.shade_secondary: device ms between the CUDA events of the
program's pass.gi.shade_secondary span (render/gi_passes.py::
shade_secondary_surfaces_pass: light sampling and shading at the
secondary surfaces, with their BRDF-candidate trace), a window frame."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.gi.shade_secondary")
