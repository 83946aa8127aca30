"""The frame entry point, port of the reference-mode part of
raytracer2_tpu/render/frame.py: Renderer, create_renderer, the frame state
the reference branch reads and writes, and render_frame.

Only the reference branch (GConst.refrence_mode=1, frame.py:242-267 of
the JAX package) is ported. The ReSTIR frame (G-buffer, lights, DI, GI)
lands slice by slice (ROADMAP queue A, items 2-5); until then
render_frame raises rather than render anything in its place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracer2_tpu_torch.params import GConst
from raytracer2_tpu_torch.render.app_bridge import Tracers, make_tracers
from raytracer2_tpu_torch.render.postprocess import (
    PostProcessInputs, post_process)
from raytracer2_tpu_torch.render.reference import render_reference
from raytracer2_tpu_torch.render.shading import store_shading_output
from raytracer2_tpu_torch.scene.scene import Scene


class FrameState(NamedTuple):
    """Persistent cross-frame state: the lighting images the reference
    branch blends into. G-buffers, motion and reservoirs join with their
    slices."""

    diffuse_lighting: torch.Tensor  # [H, W, 3]
    specular_lighting: torch.Tensor  # [H, W, 3]


def init_frame_state(width: int, height: int, *, device) -> FrameState:
    return FrameState(
        diffuse_lighting=torch.zeros((height, width, 3), device=device),
        specular_lighting=torch.zeros((height, width, 3), device=device))


@dataclasses.dataclass(frozen=True)
class Renderer:
    """Per-scene resources: the scene tensors and traversal closures. Light
    tables and RIS presampling come with the DI slice."""

    scene: Scene
    tracers: Tracers
    width: int
    height: int


def create_renderer(scene: Scene, width: int, height: int,
                    backend: str = "auto") -> Renderer:
    return Renderer(scene=scene, tracers=make_tracers(scene, backend=backend),
                    width=width, height=height)


def render_frame(renderer: Renderer, g_const: GConst, state: FrameState
                 ) -> tuple[FrameState, torch.Tensor]:
    """One frame: (new state, display image [H, W, 3] in [0, 1])."""
    if not g_const.refrence_mode:
        raise NotImplementedError(
            "render_frame runs the reference mode (refrence_mode=1) only; "
            "the ReSTIR DI/GI frame arrives with ROADMAP queue A items 2-5 "
            "(G-buffer, lights, DI, GI)")
    scene = renderer.scene
    width, height = renderer.width, renderer.height
    radiance = render_reference(scene, g_const, width, height,
                                trace_fn=renderer.tracers.closest_hit)
    diffuse, specular = store_shading_output(
        state.diffuse_lighting, state.specular_lighting,
        radiance, torch.zeros_like(radiance), is_first_pass=True,
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation))
    new_state = state._replace(diffuse_lighting=diffuse,
                               specular_lighting=specular)
    zeros3 = torch.zeros_like(radiance)
    inputs = PostProcessInputs(
        depth=torch.zeros((height, width), device=radiance.device),
        diffuse_albedo=zeros3, specular_f0=zeros3, emissive=zeros3,
        diffuse=diffuse, specular=specular)
    output, _ = post_process(scene, g_const, inputs)
    return new_state, output
