"""pass_ms.post: device time between CUDA events around each call of
post-processing (render/postprocess.py::post_process, the AgX display
transform), ms a window frame."""

UNIT = "ms"
SPAN = "post"


def install(run):
    run.span(SPAN, "raytracer2_tpu_torch.render.frame:post_process")


def read(run):
    return run.span_ms_per_frame(SPAN)
