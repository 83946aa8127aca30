"""pass_ms.gi: device time between CUDA events around each call of the GI
chain's passes (render/gi_passes.py: BRDF rays, secondary shading, GI
temporal and spatial resampling, GI final shading), summed, ms a window
frame."""

UNIT = "ms"
SPAN = "gi"
TARGETS = tuple(f"raytracer2_tpu_torch.render.frame:{f}" for f in (
    "brdf_rays_pass", "shade_secondary_surfaces_pass", "gi_temporal_pass",
    "gi_spatial_pass", "gi_final_shading_pass"))


def install(run):
    run.span(SPAN, *TARGETS)


def read(run):
    return run.span_ms_per_frame(SPAN)
