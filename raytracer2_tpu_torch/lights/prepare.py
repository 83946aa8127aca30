"""Emissive light-table preparation, port of
raytracer2_tpu/lights/prepare.py (src/prepare_lights.rs:182-255,
src/shaders/prepare_lights.comp).

- geometry_to_light with the 0xFFFFFFFF sentinel (prepare_lights.rs:190-207);
- one triangle-light record per emissive triangle (StoreTriangleLight,
  prepare_lights.comp:105-120) with radiance = emission * 12 (the Hit.glsl
  quirk, applied in prepare_lights.comp:105 too), built from the
  world-space triangle soup;
- flux scattered into the Z-curve local-light pdf texture + its mips;
- the environment record at light index `lights + 1` (main.rs:381-386);
- the environment pdf (luminance x cos(elevation)) and its mips when the
  scene has a skybox (a scene without one has a 1x1 skybox and none);
- the RIS-tile presamples of the local lights and of the environment.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer2_tpu_torch.lights import pdf_texture
from raytracer2_tpu_torch.lights.polymorphic import (
    LightInfo, empty_light_info, get_power, store_environment_light,
    store_triangle_lights)
from raytracer2_tpu_torch.params import RTXDI_INVALID_LIGHT_INDEX
from raytracer2_tpu_torch.scene.scene import EMISSION_SCALE, Scene
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.packing import zcurve_to_linear


class SceneLights(NamedTuple):
    """Per-scene light resources (render_resources.rs:143-239)."""

    lights: LightInfo  # [num_lights + 2] (locals, pad, environment)
    geometry_to_light: torch.Tensor  # [G] int64 (uint32, sentinel INVALID)
    num_local_lights: int
    local_pdf_mips: tuple  # local-light power pyramid
    env_pdf_mips: tuple | None  # environment luminance pyramid


def prepare_lights(scene: Scene) -> SceneLights:
    """Build the light table and pdf textures once per scene, as the
    reference's frame-1 prepare pass does (main.rs:663-697)."""
    dev = scene.device
    g = scene.num_geometries
    emission = (scene.host_emission if scene.host_emission is not None
                else scene.geometry.emission.cpu().numpy())
    tri_geo = (scene.host_tri_geometry
               if scene.host_tri_geometry is not None
               else scene.tri_geometry.cpu().numpy())
    is_emissive = (np.any(emission[:, :3] != 0.0, axis=-1) if g
                   else np.zeros(0, bool))
    index_counts = (np.bincount(tri_geo, minlength=g).astype(np.int64)
                    if g else np.zeros(0, np.int64))

    # light buffer offsets per geometry (prepare_lights.rs:182-209)
    geometry_to_light = np.full(g, RTXDI_INVALID_LIGHT_INDEX, np.int64)
    offset = 0
    for gi in range(g):
        if is_emissive[gi]:
            geometry_to_light[gi] = offset
            offset += int(index_counts[gi])
    num_local = offset

    # emissive triangles in (geometry, primitive) order: the soup already
    # is, so a stable mask keeps the task order
    sel = torch.from_numpy(np.nonzero(is_emissive[tri_geo])[0]).to(dev)
    if num_local > 0:
        radiance = (scene.geometry.emission[scene.tri_geometry[sel].long()]
                    [..., :3] * EMISSION_SCALE)
        tri_lights = store_triangle_lights(
            scene.tri_v0[sel], scene.tri_edge1[sel], scene.tri_edge2[sel],
            radiance)
        flux = get_power(tri_lights)
    else:
        tri_lights = empty_light_info(0, device=dev)
        flux = torch.zeros(0, device=dev)

    # slot num_local stays empty (the empty infinite-light region sits
    # there); the environment record follows it
    env_size = (int(scene.skybox.shape[1]), int(scene.skybox.shape[0]))
    env_light = store_environment_light(env_size, device=dev)
    lights = LightInfo(*(torch.cat(parts) for parts in zip(
        tri_lights, empty_light_info(1, device=dev), env_light)))

    tex_w, tex_h, _ = pdf_texture.compute_pdf_texture_size(max(num_local, 1))
    local_mips = pdf_texture.build_mip_chain(
        pdf_texture.local_light_pdf_base(flux, tex_w, tex_h))
    env_mips = None
    if scene.skybox.shape[0] > 1:
        # pow2-padded, sized from the skybox (render_resources.rs:208)
        ew, eh, _ = pdf_texture.compute_pdf_texture_size(
            scene.skybox.shape[0] * scene.skybox.shape[1])
        env_mips = pdf_texture.build_mip_chain(
            pdf_texture.environment_pdf_base(scene.skybox, (ew, eh)))
    return SceneLights(
        lights=lights,
        geometry_to_light=torch.from_numpy(geometry_to_light).to(dev),
        num_local_lights=num_local, local_pdf_mips=local_mips,
        env_pdf_mips=env_mips)


def _slot_samplers(rng_seed: int, n: int, device) -> rtrng.RngState:
    """One sampler per RIS slot, seeded by its linear index (the compute
    shaders seed by dispatch coordinates; the layout differs, the
    statistics match)."""
    idx = torch.arange(n, device=device)
    return rtrng.RngState(
        seed=(rtrng.jenkins_hash(idx) + rng_seed) & 0xFFFFFFFF,
        index=torch.ones_like(idx))


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def presample_local_lights(rng_seed: int, scene_lights: SceneLights,
                           tile_count: int = 128, tile_size: int = 1024
                           ) -> torch.Tensor:
    """RIS-tile presampling (presample_locallights.comp,
    PresamplingFunctions.hlsli:96-133): [tile_count * tile_size, 2] int64
    holding uint32 (light index, invPdf bits), one mip descent per slot."""
    n = tile_count * tile_size
    mips = scene_lights.local_pdf_mips
    x, y, pdf, _ = pdf_texture.sample_pdf_mipmap(
        _slot_samplers(rng_seed, n, mips[0].device), mips, (n,))
    ok = pdf > 0.0
    inv_pdf = torch.where(ok, 1.0 / torch.clamp_min(pdf, 1e-30), 0.0)
    entry_index = torch.where(ok, zcurve_to_linear(x, y), 0)
    return torch.stack([entry_index, _f32_bits(inv_pdf)], dim=-1)


def presample_environment_map(rng_seed: int, scene_lights: SceneLights,
                              tile_count: int = 128, tile_size: int = 1024
                              ) -> torch.Tensor:
    """Environment presampling (presample_environment.comp,
    PresamplingFunctions.hlsli:135-162): [tile_count * tile_size, 2] int64
    holding uint32 (packed uv, invPdf bits). Each slot descends the
    environment pdf mips, then jitters inside the chosen texel with the
    next two uniforms of the same sampler."""
    mips = scene_lights.env_pdf_mips
    if mips is None:
        raise ValueError("the scene has no environment pdf (no skybox)")
    n = tile_count * tile_size
    x, y, pdf, state = pdf_texture.sample_pdf_mipmap(
        _slot_samplers(rng_seed, n, mips[0].device), mips, (n,))
    jx, state = rtrng.sample_uniform(state)
    jy, state = rtrng.sample_uniform(state)
    h, w = mips[0].shape
    u = torch.clamp((x.to(torch.float32) + jx) / w, 0.0, 1.0)
    v = torch.clamp((y.to(torch.float32) + jy) / h, 0.0, 1.0)
    # float32 products truncated to integers, as the uint32 conversion does
    packed_uv = ((u * 0xFFFF).to(torch.int64)
                 | ((v * 0xFFFF).to(torch.int64) << 16)) & 0xFFFFFFFF
    inv_pdf = torch.where(pdf > 0.0, 1.0 / torch.clamp_min(pdf, 1e-30), 0.0)
    return torch.stack([packed_uv, _f32_bits(inv_pdf)], dim=-1)
