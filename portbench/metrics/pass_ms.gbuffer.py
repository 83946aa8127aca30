"""pass_ms.gbuffer: device time between CUDA events around each call of
the G-buffer pass (render/gbuffer.py::gbuffer_pass, as render_frame
calls it), ms a window frame."""

UNIT = "ms"
SPAN = "gbuffer"


def install(run):
    run.span(SPAN, "raytracer2_tpu_torch.render.frame:gbuffer_pass")


def read(run):
    return run.span_ms_per_frame(SPAN)
