"""Primary-ray G-buffer pass, port of raytracer2_tpu/render/gbuffer.py
(src/shaders/lighting_passes/g_buffer.rgen).

One camera ray per pixel; hit attributes are packed into the reference's
formats (render_resources.rs:39-101): depth R32F, oct-unorm32 normals,
R11G11B10 albedo, RGBA8-gamma specular+roughness, emissive and motion as
float32. uint32 planes are int64 tensors holding uint32 values.

Rays are traced in the coherent pixel-tile layout (8x16 tiles when the
viewport divides, else the Z-curve), presorted, so each bundle is a
compact screen tile and the tracer skips its sort. The shading fetch and
packing run in that order too; only the packed planes return to row-major
order, as one [N, 10] int32 block (floats ride as their bits).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer2_tpu_torch.params import (
    BACKGROUND_DEPTH, GConst, PlanarViewConstants)
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.surface import (
    Surface, get_surface_diffuse_probability)
from raytracer2_tpu_torch.scene.scene import Scene, get_geometry_from_hit
from raytracer2_tpu_torch.utils import packing as pk
from raytracer2_tpu_torch.utils.brdf import normalize

FETCH_CHUNK = 1 << 21  # pixels per material fetch + pack step


class GBuffer(NamedTuple):
    """Packed G-buffer planes (ref: render_resources.rs:39-46, 52-101)."""

    depth: torch.Tensor  # [H, W] f32
    normals: torch.Tensor  # [H, W] u32 oct-unorm32
    geo_normals: torch.Tensor  # [H, W] u32
    diffuse_albedo: torch.Tensor  # [H, W] u32 R11G11B10
    specular_rough: torch.Tensor  # [H, W] u32 RGBA8-gamma (F0, roughness)
    emissive: torch.Tensor  # [H, W, 3] f32


def empty_gbuffer(height: int, width: int, *, device) -> GBuffer:
    def u32():
        return torch.zeros((height, width), dtype=torch.int64, device=device)

    return GBuffer(
        depth=torch.full((height, width), BACKGROUND_DEPTH, device=device),
        normals=u32(), geo_normals=u32(), diffuse_albedo=u32(),
        specular_rough=u32(),
        emissive=torch.zeros((height, width, 3), device=device))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _fetch_pack(scene: Scene, g_const: GConst, hit, origin, direction
                ) -> torch.Tensor:
    """Material fetch + motion + packing of one pixel chunk: [n, 10] i32
    (depth bits, normal, albedo, specular+roughness, emission and motion
    bits)."""
    missed = hit.missed
    attribs = torch.stack([hit.u, hit.v], dim=-1)
    geom = get_geometry_from_hit(
        scene, hit.geometry_index, hit.primitive_id, attribs,
        textures_enabled=bool(g_const.textures),
        triangle_index=hit.triangle_index)
    world_pos = origin + direction * hit.t[..., None]
    # static scene: the previous position is the current (g_buffer.rgen:28-29)
    motion = raysmod.get_motion_vector(g_const.view, g_const.prev_view,
                                       world_pos, world_pos)

    def u32_bits(x):  # uint32 values as int32 bits
        x = torch.where(missed, 0, x)
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)

    oct_n = pk.ndir_to_oct_unorm32(geom.normal)
    albedo = pk.pack_r11g11b10_ufloat(geom.diffuse_albedo)
    spec_rough = pk.pack_rgba8_gamma_ufloat(
        torch.cat([geom.specular_f0, geom.roughness[..., None]], dim=-1))
    packed = torch.stack(
        [_bits(torch.where(missed, BACKGROUND_DEPTH, hit.t)),
         u32_bits(oct_n), u32_bits(albedo), u32_bits(spec_rough)], dim=1)
    em_mo = torch.where(missed[:, None], 0.0,
                        torch.cat([geom.emission, motion], dim=1))
    return torch.cat([packed, _bits(em_mo)], dim=1)


def gbuffer_pass(scene: Scene, g_const: GConst, trace_fn, width: int,
                 height: int, row0: int = 0) -> tuple[GBuffer, torch.Tensor]:
    """Trace primary rays and fill the G-buffer + motion vectors
    (g_buffer.rgen:14-47). Returns (GBuffer, motion [H, W, 3]).

    row0: under row sharding (parallel/mesh.py) the global row of this
    tile's first row, height the tile's rows. The port's row0 is a Python
    int, so a tile takes the 8x16 layout when its own shape divides, where
    JAX's traced row0 under shard_map always takes the Z-curve: only the
    rays' order differs, which changes a hit only on a tie."""
    dev = scene.device
    tiles = raysmod.tile_shape(width, height)
    if tiles is not None:
        th, tw = tiles
        zidx = raysmod.tile_permutation(width, height, tw, th)
    else:
        zidx, zinv = raysmod.zorder_permutation(width, height)
    lin = np.arange(width * height)
    px_z = torch.from_numpy((lin % width).astype(np.int32)[zidx]).to(dev)
    py_z = torch.from_numpy(
        (lin // width + row0).astype(np.int32)[zidx]).to(dev)

    rays_z = raysmod.setup_primary_ray(px_z, py_z, g_const.view)
    hit = trace_fn(rays_z.origin, rays_z.direction, rays_z.t_min,
                   rays_z.t_max, presorted=True)

    n = width * height
    packed = torch.cat([
        _fetch_pack(scene, g_const, type(hit)(*(f[s:s + FETCH_CHUNK]
                                                for f in hit)),
                    rays_z.origin[s:s + FETCH_CHUNK],
                    rays_z.direction[s:s + FETCH_CHUNK])
        for s in range(0, n, FETCH_CHUNK)])
    if tiles is not None:
        packed = raysmod.tile_unflatten(packed, height, width, tw, th) \
            .reshape(n, -1)
    else:
        packed = packed[torch.from_numpy(zinv).long().to(dev)]

    def u32(col):
        return (packed[:, col].to(torch.int64) & pk.M32).reshape(height,
                                                                  width)

    depth = packed[:, 0].contiguous().view(torch.float32)
    em_mo = packed[:, 4:10].contiguous().view(torch.float32)
    normals = u32(1)
    gbuffer = GBuffer(
        depth=depth.reshape(height, width),
        normals=normals,
        # geo normal = shading normal (g_buffer.rgen:32-33 quirk)
        geo_normals=normals,
        diffuse_albedo=u32(2),
        specular_rough=u32(3),
        emissive=em_mo[:, 0:3].reshape(height, width, 3))
    return gbuffer, em_mo[:, 3:6].reshape(height, width, 3)


def _surface(view: PlanarViewConstants, px, py, depth, normals_u32,
             geo_normals_u32, albedo_u32, spec_rough_u32) -> Surface:
    normal = pk.oct_unorm32_to_ndir(normals_u32)
    geo_normal = pk.oct_unorm32_to_ndir(geo_normals_u32)
    albedo = pk.unpack_r11g11b10_ufloat(albedo_u32)
    spec_rough = pk.unpack_rgba8_gamma_ufloat(spec_rough_u32)
    world_pos = raysmod.view_depth_to_world_pos(view, px, py, depth)
    cam = raysmod.view_tensor(view.camera_direction_or_position,
                              depth.device)[:3]
    view_dir = normalize(cam - world_pos)
    return Surface(
        world_pos=world_pos, view_dir=view_dir, view_depth=depth,
        normal=normal, geo_normal=geo_normal, diffuse_albedo=albedo,
        specular_f0=spec_rough[..., :3], roughness=spec_rough[..., 3],
        diffuse_probability=get_surface_diffuse_probability(
            albedo, spec_rough[..., :3], view_dir, normal))


def surface_from_gbuffer_grid(gbuffer: GBuffer, view: PlanarViewConstants,
                              field: int = 0, row0: int = 0) -> Surface:
    """Surface reconstruction over the whole (or checkerboard) launch
    grid from whole planes, no per-pixel gathers; equal to
    surface_from_gbuffer at the same pixels. row0: the global row of a
    row-sharded G-buffer tile's first row."""
    h, w = gbuffer.depth.shape
    px, py = raysmod.active_pixel_grid(w, h, field,
                                       device=gbuffer.depth.device)
    py = py + row0
    g = [raysmod.gather_field(x, field) for x in gbuffer]
    return _surface(view, px, py, *g[:5])


def surface_from_gbuffer(gbuffer: GBuffer, view: PlanarViewConstants,
                         pixel_x: torch.Tensor, pixel_y: torch.Tensor,
                         width: int, height: int, row_base: int = 0
                         ) -> Surface:
    """Port of GetGBufferSurface (RtxdiApplicationBridge.glsl:295-321): a
    Surface from the packed planes at gathered pixel positions;
    out-of-view positions yield invalid surfaces. row_base: the global row
    of the G-buffer's first row when it is a (halo-padded) row tile; rows
    outside the tile clamp to its edge rows, and the view math stays
    global."""
    in_view = ((pixel_x >= 0) & (pixel_x < width)
               & (pixel_y >= 0) & (pixel_y < height))
    x = torch.clamp(pixel_x, 0, width - 1).long()
    y = torch.clamp(torch.clamp(pixel_y, 0, height - 1) - row_base, 0,
                    gbuffer.depth.shape[0] - 1).long()
    depth = torch.where(in_view, gbuffer.depth[y, x], BACKGROUND_DEPTH)
    return _surface(view, x, y + row_base, depth, gbuffer.normals[y, x],
                    gbuffer.geo_normals[y, x], gbuffer.diffuse_albedo[y, x],
                    gbuffer.specular_rough[y, x])
