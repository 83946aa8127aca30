"""The frame entry point, port of raytracer2_tpu/render/frame.py:
Renderer, create_renderer, make_regir_params, FrameState,
init_frame_state, FRAME_PASSES and render_frame.

Two branches are ported: the reference mode (GConst.refrence_mode=1,
frame.py:242-267 of the JAX package) and the ReSTIR frame graph
(frame.py:269-414): G-buffer, the DI fused pass (with DI temporal and
spatial resampling and the boiling filter where GConst asks for them, and
the DI reservoir slots' ping-pong), the GI chain (BRDF rays, secondary
shading, GI temporal and spatial resampling, GI final shading) with its
reservoir slots, and post-processing, on the full grid or on one
checkerboard field, whole or stopped after one pass. Local lights are
drawn uniformly, from the RIS tiles or from the ReGIR grid
(create_renderer(regir=True)).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raytracer2_tpu_torch.lights.pdf_texture import fill_neighbor_offsets
from raytracer2_tpu_torch.lights.prepare import (
    SceneLights, prepare_lights, presample_environment_map,
    presample_local_lights)
from raytracer2_tpu_torch.params import (
    BACKGROUND_DEPTH, GConst, LightBufferRegion)
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.app_bridge import (
    Tracers, make_bridge, make_tracers)
from raytracer2_tpu_torch.render.di_passes import di_fused_resampling_pass
from raytracer2_tpu_torch.render.gbuffer import (
    GBuffer, empty_gbuffer, gbuffer_pass, surface_from_gbuffer_grid)
from raytracer2_tpu_torch.render.gi_passes import (
    SecondaryGBuffer, brdf_rays_pass, empty_secondary_gbuffer,
    gi_final_shading_pass, gi_spatial_pass, gi_temporal_pass,
    shade_secondary_surfaces_pass)
from raytracer2_tpu_torch.render.postprocess import (
    PostProcessInputs, post_process)
from raytracer2_tpu_torch.render.reference import render_reference
from raytracer2_tpu_torch.render.shading import store_shading_output
from raytracer2_tpu_torch.restir.di_reservoir import (
    DIReservoir, empty_di_reservoir)
from raytracer2_tpu_torch.restir.gi_reservoir import (
    GIReservoir, empty_gi_reservoir)
from raytracer2_tpu_torch.restir.initial_sampling import LightSamplingContext
from raytracer2_tpu_torch.restir.regir import (
    ReGIRGridParameters, presample_regir_grid)
from raytracer2_tpu_torch.scene.scene import Scene
from raytracer2_tpu_torch.utils import packing as pk
from raytracer2_tpu_torch.utils.profiler import span


class FrameState(NamedTuple):
    """Persistent cross-frame state (render_resources.rs:130-342): the
    G-buffers (current, which becomes the previous one next frame), motion,
    the lighting images, the two GI and the two DI reservoir slots and the
    secondary G-buffer."""

    gbuffer: GBuffer
    prev_gbuffer: GBuffer
    motion: torch.Tensor  # [H, W, 3]
    diffuse_lighting: torch.Tensor  # [H, W, 3]
    specular_lighting: torch.Tensor  # [H, W, 3]
    gi_reservoirs: tuple[GIReservoir, GIReservoir]
    di_reservoirs: tuple[DIReservoir, DIReservoir]
    secondary: SecondaryGBuffer


def init_frame_state(width: int, height: int, checkerboard: bool = False,
                     *, device) -> FrameState:
    """checkerboard=True sizes the per-lane buffers (reservoirs, secondary
    G-buffer) at [H, W//2], the reservoir layout of
    RTXDI_PixelPosToReservoirPos (RtxdiHelpers.hlsli:45-51); the G-buffer,
    motion and the lighting images stay full resolution."""
    def img3():
        return torch.zeros((height, width, 3), device=device)

    w_res = width // 2 if checkerboard else width
    shape = (height, w_res)
    return FrameState(
        gbuffer=empty_gbuffer(height, width, device=device),
        prev_gbuffer=empty_gbuffer(height, width, device=device),
        motion=img3(), diffuse_lighting=img3(), specular_lighting=img3(),
        gi_reservoirs=(empty_gi_reservoir(shape, device=device),
                       empty_gi_reservoir(shape, device=device)),
        di_reservoirs=(empty_di_reservoir(shape, device=device),
                       empty_di_reservoir(shape, device=device)),
        secondary=empty_secondary_gbuffer(height, w_res, device=device))


@dataclasses.dataclass(frozen=True)
class Renderer:
    """Per-scene resources, built once at load (the reference's frame-1
    prepare/presample block, main.rs:663-697): the scene tensors, the
    traversal closures, the light table, the neighbour offsets, the
    presampled RIS tiles (local tiles at segment offset 0, environment
    tiles after them; None when presampling is off) and the ReGIR grid
    (None unless create_renderer(regir=True))."""

    scene: Scene
    tracers: Tracers
    scene_lights: SceneLights
    neighbor_offsets: torch.Tensor
    width: int
    height: int
    ris_buffer: torch.Tensor | None = None
    regir_ris_buffer: torch.Tensor | None = None
    regir_params: ReGIRGridParameters | None = None

    def light_ctx(self, g_const: GConst) -> LightSamplingContext:
        mode = (g_const.restir_di.initial_sampling_params
                .local_light_sampling_mode)
        # mode 2 without a grid samples uniformly, as in the JAX package
        has_buffers = (self.ris_buffer is not None
                       or (mode == 2 and self.regir_ris_buffer is not None))
        return LightSamplingContext(
            lights=self.scene_lights.lights,
            light_buffer_params=g_const.light_buffer_params,
            local_light_sampling_mode=mode,
            enable_presampling=has_buffers,
            ris_buffer=self.ris_buffer,
            local_ris_params=g_const.local_lights_risbuffer_segment_params,
            env_ris_params=g_const.environment_light_risbuffer_segment_params,
            regir_ris_buffer=self.regir_ris_buffer,
            regir_params=self.regir_params)


def make_regir_params(scene: Scene, cells: tuple[int, int, int] = (16, 16, 16),
                      lights_per_cell: int = 128) -> ReGIRGridParameters:
    """Grid parameters sized to the scene's bounding box, from the host
    copy of the triangles (the reference's host never enables ReGIR,
    SURVEY.md section 2.3)."""
    if scene.num_triangles and scene.host_tri_v0 is not None:
        lo = scene.host_tri_v0.min(axis=0)
        hi = scene.host_tri_v0.max(axis=0)
    else:
        lo, hi = np.zeros(3), np.ones(3)
    center = 0.5 * (lo + hi)
    cell = float(np.max((hi - lo) / np.asarray(cells))) or 1.0
    return ReGIRGridParameters(
        center=(float(center[0]), float(center[1]), float(center[2])),
        cell_size=cell, cells=cells, lights_per_cell=lights_per_cell)


def create_renderer(scene: Scene, width: int, height: int,
                    use_bvh: bool = True, backend: str = "auto",
                    presample: bool = True, regir: bool = False,
                    presample_seed: int = 0, tracer_opts: dict | None = None,
                    k_cand_per_class: dict | None = None) -> Renderer:
    """presample=True fills the RIS tile buffer once at creation, the
    static-scene equivalent of the reference's frame-1 presample dispatch
    (light_passes.rs:538-547). regir=True also builds the ReGIR grid
    (make_regir_params), which local_light_sampling_mode 2 samples.
    use_bvh, backend, the keyword arguments in tracer_opts (cluster_size,
    cull, k_cand, group, bundle_size, sort_key, shadow_order, ...) and
    k_cand_per_class go to make_tracers."""
    opts = dict(tracer_opts or {})
    if k_cand_per_class is not None:
        opts["k_cand_per_class"] = k_cand_per_class
    scene_lights = prepare_lights(scene)
    ris_buffer = None
    if presample and scene_lights.num_local_lights > 0:
        local = presample_local_lights(presample_seed, scene_lights)
        # a scene without a skybox has no environment pdf: its tiles are
        # zeros, as frame.py:167 of the JAX package fills them
        env = (presample_environment_map(presample_seed, scene_lights)
               if scene_lights.env_pdf_mips is not None
               else torch.zeros_like(local))
        ris_buffer = torch.cat([local, env])
    regir_buf = regir_p = None
    if regir and scene_lights.num_local_lights > 0:
        regir_p = make_regir_params(scene)
        regir_buf = presample_regir_grid(
            presample_seed, scene_lights.lights,
            LightBufferRegion(first_light_index=0,
                              num_lights=scene_lights.num_local_lights),
            regir_p)
    return Renderer(
        scene=scene,
        tracers=make_tracers(scene, use_bvh=use_bvh, backend=backend,
                             **opts),
        scene_lights=scene_lights,
        neighbor_offsets=fill_neighbor_offsets(device=scene.device),
        width=width, height=height, ris_buffer=ris_buffer,
        regir_ris_buffer=regir_buf, regir_params=regir_p)


# the passes in execution order: render_frame(stop_after=name) ends the
# frame after that pass, so the differences of the prefixes' times give
# each pass's time
FRAME_PASSES = ("gbuffer", "di", "brdf_rays", "shade_secondary",
                "gi_temporal", "gi_spatial", "gi_final", "post")


def render_frame(renderer: Renderer, g_const: GConst, state: FrameState,
                 stop_after: str | None = None, row0: int = 0,
                 halo_fn=None, halo_rows: int = 8):
    """One frame (light_passes.rs:550-663 + post-process + frame-state
    rotation): (new state, display image [H, W, 3] in [0, 1]).

    stop_after (a FRAME_PASSES name) ends a ReSTIR frame after that pass
    and returns (state, that pass's intermediate tuple), the input state
    and not an image, as the JAX package's prefixes do; "post" is the
    whole frame. Under a checkerboard field (runtime_params.
    active_checkerboard_field 1 or 2) every lighting pass launches on the
    active half of the pixels and the inactive half keeps last frame's
    lighting; the state must come from init_frame_state(checkerboard=True).
    The input state is never written to.

    Row sharding (parallel/mesh.py::make_sharded_render_fn): `state` holds
    one row tile of the frame state, row0 is its first global row and
    halo_fn(tree, r) pads row tiles with r rows of each neighbour tile
    (parallel/halo.py). The stencil passes (temporal reprojection, the
    spatial neighbours) read through the halo; pixel RNG and the view
    math stay global, so a tile's image equals those rows of the whole
    frame wherever no read leaves its halo. The image is the tile's.

    Each pass runs inside a utils/profiler.span, a no-op until spans are
    enabled: pass.gbuffer; pass.bridge (the active field's gathers, the
    bridge, the light context, the primary surface); pass.di;
    pass.gi.brdf_rays, pass.gi.shade_secondary, pass.gi.temporal,
    pass.gi.spatial, pass.gi.final; pass.post (the field's scatter, the
    post inputs' unpacking, post_process); pass.reference in reference
    mode, then pass.post."""
    if stop_after is not None and stop_after not in FRAME_PASSES:
        raise ValueError(f"stop_after must be one of {FRAME_PASSES}, "
                         f"not {stop_after!r}")
    scene = renderer.scene
    width, height = renderer.width, renderer.height
    height_local = state.gbuffer.depth.shape[0]
    prev_gbuffer = state.gbuffer

    if g_const.refrence_mode:
        with span("pass.reference"):
            radiance = render_reference(scene, g_const, width, height,
                                        trace_fn=renderer.tracers.closest_hit)
            diffuse, specular = store_shading_output(
                state.diffuse_lighting, state.specular_lighting,
                radiance, torch.zeros_like(radiance), is_first_pass=True,
                enable_accumulation=g_const.enable_accumulation,
                blend_factor=g_const.blend_factor,
                correct_specular_accumulation=bool(
                    g_const.correct_specular_accumulation))
        new_state = state._replace(prev_gbuffer=prev_gbuffer,
                                   diffuse_lighting=diffuse,
                                   specular_lighting=specular)
        with span("pass.post"):
            zeros3 = torch.zeros_like(radiance)
            inputs = PostProcessInputs(
                depth=torch.zeros((height, width), device=radiance.device),
                diffuse_albedo=zeros3, specular_f0=zeros3, emissive=zeros3,
                diffuse=diffuse, specular=specular)
            output, _ = post_process(scene, g_const, inputs)
        return new_state, output

    # checkerboard rendering (RtxdiHelpers.hlsli:16-61): field 1 or 2
    # launches every lighting pass on that half of the pixels; the
    # G-buffer and post stay full resolution
    field = int(g_const.runtime_params.active_checkerboard_field)
    w_res = width // 2 if field else width
    if state.secondary.pdf.shape != (height_local, w_res):
        raise ValueError(
            f"field {field} needs a state of [{height_local}, {w_res}] "
            f"reservoirs (init_frame_state(checkerboard={bool(field)})), not "
            f"{list(state.secondary.pdf.shape)}")

    # 1. G-buffer pass (light_passes.rs:598-606)
    with span("pass.gbuffer"):
        gbuffer, motion = gbuffer_pass(scene, g_const,
                                       renderer.tracers.closest_hit, width,
                                       height_local, row0=row0)
    if stop_after == "gbuffer":
        return state, (gbuffer, motion)
    gi_slots = list(state.gi_reservoirs)
    di_slots = list(state.di_reservoirs)
    secondary = state.secondary
    with span("pass.bridge"):
        # the passes read and write the active field of the persistent
        # lighting images, scattered back after the GI chain
        diffuse = raysmod.gather_field(state.diffuse_lighting, field)
        specular = raysmod.gather_field(state.specular_lighting, field)
        motion_act = raysmod.gather_field(motion, field)
        if g_const.enable_restir_di or g_const.enable_restir_gi:
            lights = renderer.scene_lights
            # under sharding the bridge reads halo-padded G-buffer tiles, so
            # the neighbours' surface reads stay on the tile
            bridge_gbuffer, bridge_prev, row_base = gbuffer, prev_gbuffer, 0
            if halo_fn is not None:
                bridge_gbuffer = halo_fn(gbuffer, halo_rows)
                bridge_prev = halo_fn(prev_gbuffer, halo_rows)
                row_base = row0 - halo_rows
            bridge = make_bridge(
                scene, renderer.tracers, bridge_gbuffer, bridge_prev,
                g_const, lights.lights, lights.geometry_to_light,
                lights.local_pdf_mips, lights.env_pdf_mips,
                renderer.neighbor_offsets, width, height, row_base=row_base)
            light_ctx = renderer.light_ctx(g_const)
            # every lighting pass reads the primary surface at the launch
            # grid: reconstructed once, from whole planes
            primary = surface_from_gbuffer_grid(gbuffer, g_const.view, field,
                                                row0=row0)

    # 2. DI fused resampling (light_passes.rs:608-619); with
    # enable_di_resampling != 0 the shaded reservoir also goes to the
    # temporal input slot for the next frame (main.rs:649-651)
    if g_const.enable_restir_di:
        di_idx = g_const.restir_di.buffer_indices
        with span("pass.di"):
            di_res, diffuse, specular = di_fused_resampling_pass(
                g_const, bridge, light_ctx, diffuse, specular, width,
                height_local, field=field, primary_surface=primary,
                motion=motion_act,
                prev_di_reservoirs=state.di_reservoirs[
                    di_idx.temporal_resampling_input_buffer_index],
                row0=row0, halo_fn=halo_fn, halo_rows=halo_rows)
        di_slots[di_idx.shading_input_buffer_index] = di_res
        if g_const.enable_di_resampling:
            di_slots[di_idx.temporal_resampling_input_buffer_index] = di_res
    if stop_after == "di":
        return state, (diffuse, specular)

    # 3. ReSTIR GI chain (light_passes.rs:621-660)
    if g_const.enable_restir_gi:
        gi_idx = g_const.restir_gi.buffer_indices
        with span("pass.gi.brdf_rays"):
            secondary, diffuse, specular = brdf_rays_pass(
                scene, g_const, renderer.tracers, bridge, diffuse, specular,
                width, height_local, field=field, primary_surface=primary,
                row0=row0)
        if stop_after == "brdf_rays":
            return state, (secondary, diffuse, specular)
        with span("pass.gi.shade_secondary"):
            current, secondary, diffuse, specular = (
                shade_secondary_surfaces_pass(
                    scene, g_const, renderer.tracers, bridge, light_ctx,
                    secondary, diffuse, specular, width, height_local,
                    field=field, primary_surface=primary, row0=row0))
        gi_slots[gi_idx.secondary_surface_restir_di_output_buffer_index] = \
            current
        if stop_after == "shade_secondary":
            return state, (current, diffuse, specular)
        if g_const.enable_temporal_resampling:
            prev_src = state.gi_reservoirs[
                gi_idx.temporal_resampling_input_buffer_index]
            with span("pass.gi.temporal"):
                current = gi_temporal_pass(
                    g_const, bridge, current, prev_src, motion_act, width,
                    height_local, field=field, primary_surface=primary,
                    row0=row0, halo_fn=halo_fn, halo_rows=halo_rows)
            gi_slots[gi_idx.temporal_resampling_output_buffer_index] = current
        if stop_after == "gi_temporal":
            return state, (current, diffuse, specular)
        if g_const.enable_spatial_resampling:
            with span("pass.gi.spatial"):
                current = gi_spatial_pass(g_const, bridge, current, width,
                                          height_local, field=field,
                                          primary_surface=primary, row0=row0,
                                          halo_fn=halo_fn)
            gi_slots[gi_idx.spatial_resampling_output_buffer_index] = current
        if stop_after == "gi_spatial":
            return state, (current, diffuse, specular)
        with span("pass.gi.final"):
            diffuse, specular = gi_final_shading_pass(
                g_const, bridge, current, secondary, diffuse, specular,
                width, height_local, field=field, primary_surface=primary,
                row0=row0)
    if stop_after == "gi_final":
        return state, (diffuse, specular)

    # 4. post-process (post_processing.comp), after the active field's
    # lighting is scattered back into the persistent images
    with span("pass.post"):
        diffuse = raysmod.scatter_field(state.diffuse_lighting, diffuse,
                                        field)
        specular = raysmod.scatter_field(state.specular_lighting, specular,
                                         field)
        inputs = PostProcessInputs(
            depth=gbuffer.depth,
            diffuse_albedo=pk.unpack_r11g11b10_ufloat(gbuffer.diffuse_albedo),
            specular_f0=pk.unpack_rgba8_gamma_ufloat(
                gbuffer.specular_rough)[..., :3],
            emissive=gbuffer.emissive, diffuse=diffuse, specular=specular)
        output, env_motion = post_process(scene, g_const, inputs, row0=row0)
        background = (gbuffer.depth == BACKGROUND_DEPTH)[..., None]
        motion = torch.cat([torch.where(background, env_motion,
                                        motion[..., :2]),
                            motion[..., 2:]], dim=-1)
    new_state = FrameState(
        gbuffer=gbuffer, prev_gbuffer=prev_gbuffer, motion=motion,
        diffuse_lighting=diffuse, specular_lighting=specular,
        gi_reservoirs=(gi_slots[0], gi_slots[1]),
        di_reservoirs=(di_slots[0], di_slots[1]), secondary=secondary)
    return new_state, output
