"""pass_ms.di: device time between CUDA events around each call of the
DI pass (render/di_passes.py::di_fused_resampling_pass: initial light
sampling, DI resampling, shading and its visibility), ms a window
frame."""

UNIT = "ms"
SPAN = "di"


def install(run):
    run.span(SPAN, "raytracer2_tpu_torch.render.frame:di_fused_resampling_pass")


def read(run):
    return run.span_ms_per_frame(SPAN)
