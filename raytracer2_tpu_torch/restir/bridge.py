"""The resampling-library <-> application bridge contract, port of
raytracer2_tpu/restir/bridge.py (lighting_passes/RtxdiApplicationBridge.glsl).

The ReSTIR library is written against this NamedTuple of closures; scene
access, G-buffer reads and ray tracing are injected by the renderer
(render/app_bridge.py::make_bridge). Every closure works on whole pixel
tensors, and each pass calls the visibility closures a fixed number of
times on full batches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Bridge(NamedTuple):
    """RAB_* closure bundle; members mirror RtxdiApplicationBridge.glsl."""

    # RAB_GetGBufferSurface (bridge:328-344): (px, py, previous_frame) -> Surface
    get_gbuffer_surface: Callable
    # RAB_GetLightSampleTargetPdfForSurface (bridge:478-500)
    get_light_sample_target_pdf: Callable
    # RAB_GetGISampleTargetPdfForSurface (bridge:687-694):
    # (sample_pos, sample_radiance, surface) -> [...] f32
    get_gi_sample_target_pdf: Callable
    # RAB_GetConservativeVisibility (bridge:700-703):
    # (surface, sample_position) -> visible mask
    get_conservative_visibility: Callable
    # RAB_GetTemporalConservativeVisibility (bridge:708-711)
    get_temporal_conservative_visibility: Callable
    # RAB_AreMaterialsSimilar (bridge:600-616)
    are_materials_similar: Callable
    # RAB_SamplePolymorphicLight (bridge:514-525): (info, surface, uv)
    sample_polymorphic_light: Callable
    # RAB_LoadLightInfo (bridge:556-559): (index, previous_frame) -> LightInfo
    load_light_info: Callable
    # RAB_GetSurfaceBrdfSample / Pdf (bridge:437-470)
    get_surface_brdf_sample: Callable
    get_surface_brdf_pdf: Callable
    # RAB_TraceRayForLocalLight (bridge:639-669):
    # (origins, directions, t_min, t_max) -> (hit_anything, light_index, rand_xy)
    trace_ray_for_local_light: Callable
    # RAB_EvaluateLocalLightSourcePdf / EnvironmentMapSamplingPdf
    # (bridge:397-434)
    evaluate_local_light_source_pdf: Callable
    evaluate_environment_map_sampling_pdf: Callable
    # low-discrepancy neighbour offsets [N, 2] in [-1, 1]
    neighbor_offsets: torch.Tensor
    # (width, height) for RAB_ClampSamplePositionIntoView
    viewport: tuple[int, int]
    # the DI spatial resampling stage as one kernel over the data behind
    # the closures above (ops/di_spatial.py::make_runner), called with
    # di_spatial_resampling's arguments but the bridge; None where the
    # frame's data is not on a CUDA device
    di_spatial_kernel: Callable | None = None


def validate_gi_sample_with_jacobian(jacobian: torch.Tensor
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RAB_ValidateGISampleWithJacobian (bridge:673-684): reject if the
    solid-angle ratio is >10x off, else clamp to [1/3, 3].
    Returns (valid_mask, clamped_jacobian)."""
    valid = (jacobian <= 10.0) & (jacobian >= 0.1)
    return valid, torch.clamp(jacobian, 1.0 / 3.0, 3.0)
