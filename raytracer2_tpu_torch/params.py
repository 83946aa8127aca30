"""The configuration surface: GConst and friends as plain dataclasses.

Field-for-field port of raytracer2_tpu/params.py (the reference's
uber-uniform, src/shader_params.rs:245-274, with the startup defaults of
src/main.rs:237-400). PyTorch runs eagerly, so there is no split between
traced data leaves and static metadata: per-frame values (frame index,
blend factor, RNG seeds) are plain Python numbers and the view matrices
are numpy arrays that each pass moves to its device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

# Compile-time constants (ref: src/main.rs:56-58)
NEIGHBOR_OFFSET_COUNT = 8192
RTXDI_RESERVOIR_BLOCK_SIZE = 16

BACKGROUND_DEPTH = 100000.0  # (ref: ShaderParameters.glsl:12)

# SecondaryGBuffer flag bits (ref: ShaderParameters.glsl:21-23)
K_SECONDARY_IS_SPECULAR_RAY = 1
K_SECONDARY_IS_DELTA_SURFACE = 2
K_SECONDARY_IS_ENVIRONMENT_MAP = 4

RTXDI_INVALID_LIGHT_INDEX = 0xFFFFFFFF

_frozen = dataclasses.dataclass(frozen=True)


class PlanarViewConstants(NamedTuple):
    """Camera matrices + viewport transforms (ref: shader_params.rs:5-26,
    produced by camera.rs:111-142). Members are float32 numpy arrays."""

    mat_world_to_view: np.ndarray  # [4,4]
    mat_view_to_clip: np.ndarray  # [4,4]
    mat_world_to_clip: np.ndarray  # [4,4]
    mat_clip_to_view: np.ndarray  # [4,4]
    mat_view_to_world: np.ndarray  # [4,4]
    mat_clip_to_world: np.ndarray  # [4,4]
    viewport_origin: np.ndarray  # [2]
    viewport_size: np.ndarray  # [2]
    viewport_size_inv: np.ndarray  # [2]
    pixel_offset: np.ndarray  # [2]
    clip_to_window_scale: np.ndarray  # [2]
    clip_to_window_bias: np.ndarray  # [2]
    window_to_clip_scale: np.ndarray  # [2]
    window_to_clip_bias: np.ndarray  # [2]
    camera_direction_or_position: np.ndarray  # [4]


@_frozen
class RuntimeParameters:
    """(ref: shader_params.rs:30-35)."""

    neighbor_offset_mask: int = NEIGHBOR_OFFSET_COUNT - 1
    active_checkerboard_field: int = 0  # 0 none, 1 odd, 2 even


@_frozen
class ReservoirBufferParameters:
    """Block-linear reservoir layout (ref: shader_params.rs:96-101,
    computed by light_passes.rs:718-731)."""

    reservoir_block_row_pitch: int = 0
    reservoir_array_pitch: int = 0


def calculate_reservoir_buffer_parameters(
    render_width: int, render_height: int,
    block_size: int = RTXDI_RESERVOIR_BLOCK_SIZE,
) -> ReservoirBufferParameters:
    """Port of light_passes.rs:718-731."""
    render_width_blocks = (render_width + block_size - 1) // block_size
    render_height_blocks = (render_height + block_size - 1) // block_size
    block_row_pitch = render_width_blocks * block_size * block_size
    return ReservoirBufferParameters(
        reservoir_block_row_pitch=block_row_pitch,
        reservoir_array_pitch=block_row_pitch * render_height_blocks,
    )


# ---------------------------------------------------------------------------
# ReSTIR GI parameters (defaults from main.rs:240-283)
# ---------------------------------------------------------------------------

@_frozen
class GIBufferIndices:
    """2-slot reservoir ping-pong indices (ref: shader_params.rs:82-92)."""

    secondary_surface_restir_di_output_buffer_index: int = 0
    temporal_resampling_input_buffer_index: int = 1
    temporal_resampling_output_buffer_index: int = 0
    spatial_resampling_input_buffer_index: int = 0
    spatial_resampling_output_buffer_index: int = 1
    final_shading_input_buffer_index: int = 0


@_frozen
class GIFinalShadingParameters:
    """(ref: shader_params.rs:73-78; defaults main.rs:251-256)."""

    enable_final_mis: int = 1
    enable_final_visibility: int = 0


@_frozen
class GISpatialResamplingParameters:
    """(ref: shader_params.rs:59-69; defaults main.rs:258-269)."""

    spatial_depth_threshold: float = 0.1
    spatial_normal_threshold: float = 0.3
    num_spatial_samples: int = 1
    spatial_bias_correction_mode: int = 2
    spatial_sampling_radius: float = 3.0


@_frozen
class GITemporalResamplingParameters:
    """(ref: shader_params.rs:39-54; defaults main.rs:270-283)."""

    boiling_filter_strength: float = 0.0
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_boiling_filter: int = 0
    enable_fallback_sampling: int = 1
    enable_permutation_sampling: int = 0
    max_history_length: int = 20
    max_reservoir_age: int = 50
    temporal_bias_correction_mode: int = 2
    uniform_random_number: int = 0  # uint32


@_frozen
class GIParameters:
    """(ref: shader_params.rs:105-111)."""

    reservoir_buffer_params: ReservoirBufferParameters = dataclasses.field(
        default_factory=ReservoirBufferParameters)
    buffer_indices: GIBufferIndices = dataclasses.field(
        default_factory=GIBufferIndices)
    temporal_resampling_params: GITemporalResamplingParameters = (
        dataclasses.field(default_factory=GITemporalResamplingParameters))
    spatial_resampling_params: GISpatialResamplingParameters = (
        dataclasses.field(default_factory=GISpatialResamplingParameters))
    final_shading_params: GIFinalShadingParameters = dataclasses.field(
        default_factory=GIFinalShadingParameters)


# ---------------------------------------------------------------------------
# ReSTIR DI parameters (defaults from main.rs:311-367)
# ---------------------------------------------------------------------------

@_frozen
class DIBufferIndices:
    """(ref: shader_params.rs:155-165)."""

    initial_sampling_output_buffer_index: int = 0
    temporal_resampling_input_buffer_index: int = 1
    temporal_resampling_output_buffer_index: int = 0
    spatial_resampling_input_buffer_index: int = 0
    spatial_resampling_output_buffer_index: int = 1
    shading_input_buffer_index: int = 0


@_frozen
class DIInitialSamplingParameters:
    """(ref: shader_params.rs:141-151; defaults main.rs:323-332)."""

    num_primary_local_light_samples: int = 0
    num_primary_infinite_light_samples: int = 0
    num_primary_environment_samples: int = 0
    num_primary_brdf_samples: int = 1
    brdf_cutoff: float = 0.0
    enable_initial_visibility: int = 0
    environment_map_importance_sampling: int = 0
    local_light_sampling_mode: int = 0  # 0 uniform, 1 power RIS, 2 ReGIR RIS


@_frozen
class DITemporalResamplingParameters:
    """(ref: shader_params.rs:169-184; defaults main.rs:333-346)."""

    temporal_depth_threshold: float = 0.1
    temporal_normal_threshold: float = 0.3
    max_history_length: int = 5
    temporal_bias_correction: int = 2
    enable_permutation_sampling: int = 0
    permutation_sampling_threshold: float = 0.0
    enable_boiling_filter: int = 0
    boiling_filter_strength: float = 0.0
    discard_invisible_samples: int = 1
    uniform_random_number: int = 0  # uint32


@_frozen
class DISpatialResamplingParameters:
    """(ref: shader_params.rs:188-198; defaults main.rs:347-356)."""

    spatial_depth_threshold: float = 0.1
    spatial_normal_threshold: float = 0.3
    spatial_bias_correction: int = 2
    num_spatial_samples: int = 3
    num_disocclusion_boost_samples: int = 2
    spatial_sampling_radius: float = 32.0
    neighbor_offset_mask: int = NEIGHBOR_OFFSET_COUNT - 1
    discount_naive_samples: int = 0


@_frozen
class DIShadingParameters:
    """(ref: shader_params.rs:202-212; defaults main.rs:357-366)."""

    enable_final_visibility: int = 0
    reuse_final_visibility: int = 0
    final_visibility_max_age: int = 10
    final_visibility_max_distance: float = 1000.0
    enable_denoiser_input_packing: int = 0


@_frozen
class DIParameters:
    """(ref: shader_params.rs:216-223)."""

    reservoir_buffer_params: ReservoirBufferParameters = dataclasses.field(
        default_factory=ReservoirBufferParameters)
    buffer_indices: DIBufferIndices = dataclasses.field(
        default_factory=DIBufferIndices)
    initial_sampling_params: DIInitialSamplingParameters = dataclasses.field(
        default_factory=DIInitialSamplingParameters)
    temporal_resampling_params: DITemporalResamplingParameters = (
        dataclasses.field(default_factory=DITemporalResamplingParameters))
    spatial_resampling_params: DISpatialResamplingParameters = (
        dataclasses.field(default_factory=DISpatialResamplingParameters))
    shading_params: DIShadingParameters = dataclasses.field(
        default_factory=DIShadingParameters)


# ---------------------------------------------------------------------------
# Light buffer regions / RIS segments (ref: shader_params.rs:115-137, 227-232)
# ---------------------------------------------------------------------------

@_frozen
class LightBufferRegion:
    first_light_index: int = 0
    num_lights: int = 0


@_frozen
class EnvironmentLightBufferParameters:
    light_present: int = 0
    light_index: int = 0


@_frozen
class LightBufferParameters:
    local_light_buffer_region: LightBufferRegion = dataclasses.field(
        default_factory=LightBufferRegion)
    infinite_light_buffer_region: LightBufferRegion = dataclasses.field(
        default_factory=LightBufferRegion)
    environment_light_params: EnvironmentLightBufferParameters = (
        dataclasses.field(default_factory=EnvironmentLightBufferParameters))


@_frozen
class RISBufferSegmentParameters:
    """(ref: shader_params.rs:227-232; defaults main.rs:299-310)."""

    buffer_offset: int = 0
    tile_size: int = 1024
    tile_count: int = 128


# ---------------------------------------------------------------------------
# The uber-config
# ---------------------------------------------------------------------------

@_frozen
class GConst:
    """Top-level renderer configuration (ref: shader_params.rs:245-274;
    defaults main.rs:237-400)."""

    view: PlanarViewConstants | None = None
    prev_view: PlanarViewConstants | None = None
    runtime_params: RuntimeParameters = dataclasses.field(
        default_factory=RuntimeParameters)

    enable_brdf_indirect: int = 1
    enable_brdf_additive_blend: int = 1
    enable_accumulation: int = 0
    # 0 = preserve the reference's copy-paste bug (diffuse blended into the
    # specular buffer under accumulation, ShadingHelpers.glsl:72-73);
    # 1 = accumulate specular correctly (used by the RMSE gate)
    correct_specular_accumulation: int = 0
    frame: int = 0  # uint32

    restir_gi: GIParameters = dataclasses.field(default_factory=GIParameters)
    restir_di: DIParameters = dataclasses.field(default_factory=DIParameters)

    enable_restir_di: int = 0
    enable_restir_gi: int = 1
    refrence_mode: int = 0  # [sic] reference-mode spelling kept for parity
    textures: int = 1

    blend_factor: float = 0.1
    enable_spatial_resampling: int = 0
    enable_temporal_resampling: int = 0
    environment: int = 0
    # DI spatio-temporal resampling in the fused pass (0 = the reference's
    # parity default; 1 temporal, 2 spatial, 3 both)
    enable_di_resampling: int = 0

    light_buffer_params: LightBufferParameters = dataclasses.field(
        default_factory=LightBufferParameters)
    local_lights_risbuffer_segment_params: RISBufferSegmentParameters = (
        dataclasses.field(default_factory=lambda: RISBufferSegmentParameters(
            buffer_offset=0, tile_size=1024, tile_count=128)))
    environment_light_risbuffer_segment_params: RISBufferSegmentParameters = (
        dataclasses.field(default_factory=lambda: RISBufferSegmentParameters(
            buffer_offset=1024 * 128, tile_size=1024, tile_count=128)))

    environment_pdf_texture_size: tuple[int, int] = (0, 0)
    local_light_pdf_texture_size: tuple[int, int] = (0, 0)

    def replace(self, **kwargs) -> "GConst":
        return dataclasses.replace(self, **kwargs)


def default_gconst(view: PlanarViewConstants, num_local_lights: int,
                   **overrides) -> GConst:
    """Build a GConst with the reference's startup defaults for a scene with
    `num_local_lights` emissive triangles (ref: main.rs:237-400: the light
    regions are [0, lights), infinite empty at `lights`, environment light at
    index `lights + 1`)."""
    light_params = LightBufferParameters(
        local_light_buffer_region=LightBufferRegion(0, num_local_lights),
        infinite_light_buffer_region=LightBufferRegion(num_local_lights, 0),
        environment_light_params=EnvironmentLightBufferParameters(
            light_present=1, light_index=num_local_lights + 1),
    )
    return GConst(
        view=view, prev_view=view, light_buffer_params=light_params,
        **overrides)
