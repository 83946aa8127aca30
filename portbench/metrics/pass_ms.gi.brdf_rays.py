"""pass_ms.gi.brdf_rays: device ms between the CUDA events of the
program's pass.gi.brdf_rays span (render/gi_passes.py::brdf_rays_pass:
the GI bounce rays, their closest-hit trace, the secondary G-buffer), a
window frame."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.span_ms(run, "pass.gi.brdf_rays")
