"""Device scene: SoA tensors + geometry table + material fetch.

Port of raytracer2_tpu/scene/scene.py. The host-side build is the same
numpy code (so both packages produce the same arrays bit for bit); the
arrays then land on the caller's device as torch tensors. uint32 arrays
(indices, index/vertex offsets) are carried as int64.

Material-fetch quirks preserved (Hit.glsl:40-41, :27): roughness forced to
1.0, emission scaled x12, normals transformed by the plain node matrix.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from raytracer2_tpu_torch.scene.gltf import CpuModel
from raytracer2_tpu_torch.utils.brdf import normalize as v_normalize

# Reference quirks (Hit.glsl:40-41), kept for image parity: every surface's
# roughness is forced to 1 and emission is scaled by 12.
ROUGHNESS_OVERRIDE = 1.0
EMISSION_SCALE = 12.0


class GeometryTable(NamedTuple):
    """Per-node geometry records (ref: model.rs:12-23)."""

    transform: torch.Tensor  # [G, 4, 4]
    base_color: torch.Tensor  # [G, 4]
    base_color_texture_index: torch.Tensor  # [G] int32 (-1 = none)
    metallic_factor: torch.Tensor  # [G]
    index_offset: torch.Tensor  # [G] int64 (uint32 values)
    vertex_offset: torch.Tensor  # [G] int64 (uint32 values)
    emission: torch.Tensor  # [G, 4]
    roughness: torch.Tensor  # [G]


class Scene(NamedTuple):
    """Full device scene; field meanings as in raytracer2_tpu.scene.Scene."""

    positions: torch.Tensor  # [V, 3]
    normals: torch.Tensor  # [V, 3]
    colors: torch.Tensor  # [V, 4]
    uvs: torch.Tensor  # [V, 2]
    indices: torch.Tensor  # [I] int64 (uint32 values)
    geometry: GeometryTable  # [G]

    tri_v0: torch.Tensor  # [T, 3]
    tri_edge1: torch.Tensor  # [T, 3] v1 - v0
    tri_edge2: torch.Tensor  # [T, 3] v2 - v0
    tri_geometry: torch.Tensor  # [T] int32 geometry index
    tri_primitive: torch.Tensor  # [T] int32 primitive id within its geometry

    textures: torch.Tensor  # [NT, H, W, 4] linear float32, zero-padded
    texture_sizes: torch.Tensor  # [NT, 2] int32 (w, h)
    texture_modes: torch.Tensor  # [NT, 3] int32 (nearest, wrap_s, wrap_t)

    skybox: torch.Tensor  # [h, w, 3] equirect, linear RGB

    tri_attrs: torch.Tensor  # [T, 80] packed per-triangle fetch rows
    geom_rows: torch.Tensor  # [G, 32]
    geom_tri_base: torch.Tensor  # [G] int32

    num_triangles: int
    num_geometries: int
    num_emissive_triangles: int
    default_samplers_only: bool = True
    has_textures: bool = True

    # host (numpy) copies consumed by the host-side cluster builder
    host_tri_v0: np.ndarray | None = None
    host_tri_edge1: np.ndarray | None = None
    host_tri_edge2: np.ndarray | None = None
    host_emission: np.ndarray | None = None  # [G, 4]
    host_tri_geometry: np.ndarray | None = None  # [T] int32

    textures_quad: torch.Tensor | None = None  # [NT*H*W, 16]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


_GEOMETRY_U32 = ("index_offset", "vertex_offset")
_SCENE_META = ("num_triangles", "num_geometries", "num_emissive_triangles",
               "default_samplers_only", "has_textures")
_SCENE_HOST = ("host_tri_v0", "host_tri_edge1", "host_tri_edge2",
               "host_emission", "host_tri_geometry")


def scene_from_arrays(arrays: Mapping, *, device) -> Scene:
    """Scene from numpy arrays keyed by field name (`geometry` a mapping of
    GeometryTable fields); metadata and host copies pass through."""
    def dev(a, u32=False):
        # a fresh writable copy: arrays handed over from JAX are read-only
        a = np.array(a, dtype=np.int64 if u32 else None)
        return torch.from_numpy(a).to(device)

    geo = arrays["geometry"]
    fields = {}
    for name in Scene._fields:
        if name == "geometry":
            fields[name] = GeometryTable(**{
                f: dev(geo[f], f in _GEOMETRY_U32)
                for f in GeometryTable._fields})
        elif name in _SCENE_META:
            fields[name] = type(Scene._field_defaults.get(name, 0))(
                arrays[name])
        elif name in _SCENE_HOST:
            v = arrays.get(name)
            fields[name] = None if v is None else np.asarray(v)
        elif name == "textures_quad":
            v = arrays.get(name)
            fields[name] = None if v is None else dev(v)
        else:
            fields[name] = dev(arrays[name], name == "indices")
    return Scene(**fields)


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """sRGB EOTF (Vulkan R8G8B8A8_SRGB sampling, model.rs:241)."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def scene_arrays(model: CpuModel, skybox: np.ndarray | None = None) -> dict:
    """The host half of build_scene: every Scene field as numpy (the same
    code as raytracer2_tpu.scene.scene.build_scene, ref model.rs:185-476)."""
    g = len(model.nodes)

    transforms = np.stack(
        [n.transform for n in model.nodes], axis=0) if g \
        else np.zeros((0, 4, 4), np.float32)
    base_colors = np.array(
        [n.mesh.material.base_color for n in model.nodes],
        np.float32).reshape(g, 4)
    tex_idx = np.array(
        [n.mesh.material.base_color_texture_index for n in model.nodes],
        np.int32)
    metallic = np.array(
        [n.mesh.material.metallic_factor for n in model.nodes], np.float32)
    # emission w=1.0 (model.rs:405-410)
    emission = np.array(
        [[*n.mesh.material.emission, 1.0] for n in model.nodes],
        np.float32).reshape(g, 4)
    roughness = np.array(
        [n.mesh.material.roughness for n in model.nodes], np.float32)
    index_offsets = np.array(
        [n.mesh.index_offset for n in model.nodes], np.uint32)
    vertex_offsets = np.array(
        [n.mesh.vertex_offset for n in model.nodes], np.uint32)
    index_counts = np.array(
        [n.mesh.index_count for n in model.nodes], np.uint32)

    # lights = sum of emissive-geometry triangle counts (model.rs:399-413)
    is_emissive = np.any(emission[:, :3] != 0.0, axis=-1)
    num_lights = int((index_counts[is_emissive] // 3).sum())

    # world-space triangle soup (BLAS equivalent)
    tri_v0s, tri_e1s, tri_e2s, tri_geos, tri_prims = [], [], [], [], []
    tri_vids = []
    tri_bases = np.zeros(max(g, 1), np.int32)
    tri_cursor = 0
    for gi, node in enumerate(model.nodes):
        m = node.mesh
        idx = model.indices[m.index_offset: m.index_offset + m.index_count]
        idx = idx.reshape(-1, 3).astype(np.int64) + m.vertex_offset
        p = model.positions[idx]  # [t, 3, 3]
        t4 = node.transform
        pw = p @ t4[:3, :3].T + t4[:3, 3]
        tri_v0s.append(pw[:, 0])
        tri_e1s.append(pw[:, 1] - pw[:, 0])
        tri_e2s.append(pw[:, 2] - pw[:, 0])
        n_tris = idx.shape[0]
        tri_geos.append(np.full(n_tris, gi, np.int32))
        tri_prims.append(np.arange(n_tris, dtype=np.int32))
        tri_vids.append(idx.astype(np.int32))
        tri_bases[gi] = tri_cursor
        tri_cursor += n_tris

    def cat3(parts):
        return (np.concatenate(parts, axis=0).astype(np.float32)
                if parts else np.zeros((0, 3), np.float32))

    tri_v0 = cat3(tri_v0s)
    tri_e1 = cat3(tri_e1s)
    tri_e2 = cat3(tri_e2s)
    tri_geo = (np.concatenate(tri_geos) if tri_geos
               else np.zeros((0,), np.int32))
    tri_prim = (np.concatenate(tri_prims) if tri_prims
                else np.zeros((0,), np.int32))

    # textures -> linear float, stacked zero-padded (dummy 1x1 white if none,
    # model.rs:289-355)
    if model.images and model.textures:
        from raytracer2_tpu_torch.scene.gltf import (
            FILTER_NEAREST, WRAP_CLAMP_TO_EDGE, WRAP_MIRRORED_REPEAT)

        def wrap_code(mode):
            if mode == WRAP_CLAMP_TO_EDGE:
                return 1
            if mode == WRAP_MIRRORED_REPEAT:
                return 2
            return 0

        imgs = []
        sizes = []
        modes = []
        for t in model.textures:
            img = model.images[t.image_index].astype(np.float32) / 255.0
            rgb = _srgb_to_linear(img[..., :3])
            a = img[..., 3:4]
            imgs.append(np.concatenate([rgb, a], axis=-1))
            sizes.append((img.shape[1], img.shape[0]))
            s = model.samplers[t.sampler_index] if model.samplers else None
            modes.append((
                1 if (s and s.mag_filter == FILTER_NEAREST) else 0,
                wrap_code(s.wrap_s) if s else 0,
                wrap_code(s.wrap_t) if s else 0))
        max_h = max(i.shape[0] for i in imgs)
        max_w = max(i.shape[1] for i in imgs)
        stacked = np.zeros((len(imgs), max_h, max_w, 4), np.float32)
        for i, img in enumerate(imgs):
            stacked[i, :img.shape[0], :img.shape[1]] = img
        texture_sizes = np.array(sizes, np.int32)
        texture_modes = np.array(modes, np.int32)
    else:
        stacked = np.ones((1, 1, 1, 4), np.float32)
        texture_sizes = np.array([[1, 1]], np.int32)
        texture_modes = np.zeros((1, 3), np.int32)
    default_samplers_only = bool((texture_modes == 0).all())

    # quad-packed bilinear windows: repeat wrapping baked per texture's
    # OWN size inside the padded stack
    quad = None
    if default_samplers_only and model.images and model.textures:
        quad = np.zeros(stacked.shape[:3] + (16,), np.float32)
        for i, img in enumerate(imgs):
            hi, wi = img.shape[:2]
            xp = np.roll(img, -1, axis=1)
            yp = np.roll(img, -1, axis=0)
            xyp = np.roll(yp, -1, axis=1)
            quad[i, :hi, :wi] = np.concatenate(
                [img, xp, yp, xyp], axis=-1)
        quad = quad.reshape(-1, 16)

    if skybox is None:
        skybox = np.zeros((1, 1, 3), np.float32)

    # packed fetch tables: wide rows so the shade path is a handful of row
    # gathers instead of ~20 narrow ones
    v = model.positions.shape[0]
    vertex_attrs = np.zeros((max(v, 1), 16), np.float32)
    if v:
        vertex_attrs[:, 0:3] = model.normals[:, :3]
        vertex_attrs[:, 3:5] = model.uvs[:, :2]
        vertex_attrs[:, 5:9] = model.colors[:, :4]
    tri_vertex_ids = (np.concatenate(tri_vids, axis=0) if tri_vids
                      else np.zeros((0, 3), np.int32))
    geom_rows = np.zeros((max(g, 1), 32), np.float32)
    if g:
        geom_rows[:, 0:9] = transforms[:, :3, :3].reshape(g, 9)
        geom_rows[:, 9:12] = base_colors[:, :3]
        geom_rows[:, 12] = tex_idx.astype(np.float32)
        geom_rows[:, 13] = metallic
        geom_rows[:, 14:17] = emission[:, :3]
        geom_rows[:, 17] = roughness

    return dict(
        positions=np.asarray(model.positions),
        normals=np.asarray(model.normals),
        colors=np.asarray(model.colors),
        uvs=np.asarray(model.uvs),
        indices=np.asarray(model.indices, np.uint32),
        geometry=dict(
            transform=np.asarray(transforms),
            base_color=base_colors,
            base_color_texture_index=tex_idx,
            metallic_factor=metallic,
            index_offset=index_offsets,
            vertex_offset=vertex_offsets,
            emission=emission,
            roughness=roughness,
        ),
        tri_v0=tri_v0,
        tri_edge1=tri_e1,
        tri_edge2=tri_e2,
        tri_geometry=tri_geo,
        tri_primitive=tri_prim,
        textures=stacked,
        texture_sizes=texture_sizes,
        texture_modes=texture_modes,
        skybox=np.asarray(skybox, np.float32),
        tri_attrs=np.concatenate(
            [vertex_attrs[tri_vertex_ids.reshape(-1)].reshape(-1, 48),
             geom_rows[np.asarray(tri_geo, np.int64)]], axis=1),
        geom_rows=geom_rows,
        geom_tri_base=tri_bases,
        num_triangles=int(tri_v0.shape[0]),
        num_geometries=g,
        num_emissive_triangles=num_lights,
        default_samplers_only=default_samplers_only,
        has_textures=bool(model.images and model.textures),
        host_tri_v0=np.asarray(tri_v0, np.float32),
        host_tri_edge1=np.asarray(tri_e1, np.float32),
        host_tri_edge2=np.asarray(tri_e2, np.float32),
        host_emission=emission,
        host_tri_geometry=np.asarray(tri_geo, np.int32),
        textures_quad=quad,
    )


def build_scene(model: CpuModel, skybox: np.ndarray | None = None, *,
                device) -> Scene:
    """Build the device scene from a CPU model (ref: model.rs:185-476)."""
    return scene_from_arrays(scene_arrays(model, skybox), device=device)


# ---------------------------------------------------------------------------
# Texture / environment sampling
# ---------------------------------------------------------------------------

def _lerp2(c00, c10, c01, c11, fx, fy):
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_texture_bilinear(textures: torch.Tensor, sizes: torch.Tensor,
                            tex_index: torch.Tensor, uv: torch.Tensor,
                            modes: torch.Tensor | None = None,
                            quad: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Sample the stacked texture array honoring per-texture sampler state.

    textures: [NT, H, W, 4]; tex_index: [...]; uv: [..., 2] -> [..., 4].
    modes: optional [NT, 3] (nearest, wrap_s, wrap_t); None is the default
    glTF sampler (repeat + linear). quad: optional Scene.textures_quad —
    the whole 2x2 window in one row gather, valid for the default sampler
    only. Row indices are clamped so junk uv on masked lanes can never
    index out of bounds (a device-side assert on CUDA)."""
    ti = torch.clamp_min(tex_index.long(), 0)
    w = sizes[ti, 0].to(torch.float32)
    h = sizes[ti, 1].to(torch.float32)
    if modes is not None:
        nearest = modes[ti, 0] != 0
        wrap_s = modes[ti, 1]
        wrap_t = modes[ti, 2]
    else:
        nearest = torch.zeros(ti.shape, dtype=torch.bool, device=ti.device)
        wrap_s = torch.zeros(ti.shape, dtype=torch.int32, device=ti.device)
        wrap_t = wrap_s

    # pixel-center sampling: uv*size - 0.5 (linear); floor(uv*size) with a
    # zero fraction reproduces nearest filtering exactly
    x = torch.where(nearest, torch.floor(uv[..., 0] * w),
                    uv[..., 0] * w - 0.5)
    y = torch.where(nearest, torch.floor(uv[..., 1] * h),
                    uv[..., 1] * h - 0.5)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(v, n, mode):
        v = v.to(torch.int64)
        n = torch.clamp_min(n.to(torch.int64), 1)
        repeat = torch.remainder(v, n)
        clamp = torch.minimum(torch.clamp_min(v, 0), n - 1)
        p = torch.remainder(v, 2 * n)
        mirror = torch.where(p >= n, 2 * n - 1 - p, p)
        return torch.where(mode == 1, clamp,
                           torch.where(mode == 2, mirror, repeat))

    nt, hh, ww, _ = textures.shape
    base = ti * (hh * ww)
    x0i = wrap(x0, w, wrap_s)
    y0i = wrap(y0, h, wrap_t)
    last = nt * hh * ww - 1

    def rows(table, yi, xi):
        return table[torch.clamp(base + yi * ww + xi, 0, last)]

    if quad is not None and modes is None:
        r = rows(quad, y0i, x0i)  # [..., 16]: the 2x2 window
        c00, c10 = r[..., 0:4], r[..., 4:8]
        c01, c11 = r[..., 8:12], r[..., 12:16]
    else:
        x1i = wrap(x0 + 1, w, wrap_s)
        y1i = wrap(y0 + 1, h, wrap_t)
        flat = textures.reshape(nt * hh * ww, 4)
        c00 = rows(flat, y0i, x0i)
        c10 = rows(flat, y0i, x1i)
        c01 = rows(flat, y1i, x0i)
        c11 = rows(flat, y1i, x1i)
    return _lerp2(c00, c10, c01, c11, fx, fy)


def sample_equirect(skybox: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect sample, wrap in u / clamp in v."""
    h, w = skybox.shape[0], skybox.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0l = x0.to(torch.int64)
    y0l = y0.to(torch.int64)
    x0i = torch.remainder(x0l, w)
    x1i = torch.remainder(x0l + 1, w)
    y0i = torch.clamp(y0l, 0, h - 1)
    y1i = torch.clamp(y0l + 1, 0, h - 1)
    return _lerp2(skybox[y0i, x0i], skybox[y0i, x1i],
                  skybox[y1i, x0i], skybox[y1i, x1i], fx, fy)


def get_environment_radiance(scene: Scene, direction: torch.Tensor,
                             environment: int) -> torch.Tensor:
    """(ref: RtxdiApplicationBridge.glsl:618-627)."""
    if not environment:
        return torch.zeros(direction.shape[:-1] + (3,), dtype=direction.dtype,
                           device=direction.device)
    from raytracer2_tpu_torch.utils.brdf import direction_to_equirect_uv

    return sample_equirect(scene.skybox, direction_to_equirect_uv(direction))


# ---------------------------------------------------------------------------
# Geometry / material fetch (ref: Hit.glsl)
# ---------------------------------------------------------------------------

class SurfaceGeometry(NamedTuple):
    """Interpolated hit attributes (outputs of Hit.glsl:2-42)."""

    normal: torch.Tensor  # [..., 3]
    specular_f0: torch.Tensor  # [..., 3]
    roughness: torch.Tensor  # [...]
    diffuse_albedo: torch.Tensor  # [..., 3]
    emission: torch.Tensor  # [..., 3]
    uv: torch.Tensor  # [..., 2]


def get_geometry_from_hit(
    scene: Scene,
    geometry_index: torch.Tensor,  # [...] int
    primitive_id: torch.Tensor,  # [...] int
    attribs: torch.Tensor,  # [..., 2] barycentric hit uv
    textures_enabled: bool = True,
    triangle_index: torch.Tensor | None = None,
) -> SurfaceGeometry:
    """Vectorized port of GetGeometryFromHit (Hit.glsl:2-42): one [T, 80]
    row gather (Scene.tri_attrs) per lane, attribute interpolation, the
    node-matrix normal transform (no inverse transpose, Hit.glsl:27 quirk),
    the base-color texture and the roughness/emission quirks. Values on
    lanes with invalid ids are junk; callers mask by `missed`. (The JAX
    version's chunking of 4K-class batches above 4M lanes is not needed
    here: the reference path hands it 262,144-lane chunks.)"""
    if triangle_index is not None:
        tri = torch.clamp(triangle_index.long(), 0, scene.num_triangles - 1)
    else:
        gi = torch.clamp_min(geometry_index.long(), 0)
        tri = scene.geom_tri_base[gi].long() + primitive_id.long()
        tri = torch.clamp(tri, 0, scene.num_triangles - 1)
    ta = scene.tri_attrs[tri]  # [..., 80] — the ONLY row gather
    grow = ta[..., 48:80]
    a0 = ta[..., 0:16]
    a1 = ta[..., 16:32]
    a2 = ta[..., 32:48]

    b0 = (1.0 - attribs[..., 0] - attribs[..., 1])[..., None]
    b1 = attribs[..., 0:1]
    b2 = attribs[..., 1:2]
    a = a0 * b0 + a1 * b1 + a2 * b2  # interpolate all attributes at once

    n = v_normalize(a[..., 0:3])
    t33 = grow[..., 0:9].reshape(grow.shape[:-1] + (3, 3))
    # node-matrix transform, no inverse transpose (Hit.glsl:27 quirk)
    n = v_normalize((t33 * n[..., None, :]).sum(dim=-1))

    uv = a[..., 3:5]
    vcol = a[..., 5:8]
    color = grow[..., 9:12] * vcol

    tex_index = grow[..., 12].to(torch.int32)
    if textures_enabled and scene.has_textures:
        texel = sample_texture_bilinear(
            scene.textures, scene.texture_sizes, tex_index, uv,
            modes=(None if scene.default_samplers_only
                   else scene.texture_modes),
            quad=(scene.textures_quad if scene.default_samplers_only
                  else None))[..., :3]
        color = torch.where((tex_index > -1)[..., None], color * texel, color)

    metallic = grow[..., 13:14]
    specular_f0 = color * metallic  # mix(0, color, metallic) (Hit.glsl:39)
    rough = torch.full(color.shape[:-1], ROUGHNESS_OVERRIDE,
                       dtype=color.dtype, device=color.device)
    emission = grow[..., 14:17] * EMISSION_SCALE

    return SurfaceGeometry(
        normal=n, specular_f0=specular_f0, roughness=rough,
        diffuse_albedo=color, emission=emission, uv=uv)
