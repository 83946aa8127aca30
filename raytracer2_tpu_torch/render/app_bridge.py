"""Traversal backends and the RAB_* bridge, port of
raytracer2_tpu/render/app_bridge.py: Tracers and make_tracers (closest hit
and any hit per ray class), and make_bridge, which wires scene, tracers,
G-buffers and light tables into the closure bundle the ReSTIR library
reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from raytracer2_tpu_torch.lights.pdf_texture import evaluate_pdf_texture
from raytracer2_tpu_torch.lights.polymorphic import (
    LightInfo, calc_sample, gather_light)
from raytracer2_tpu_torch.ops import cuda_pairs as cp
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import Clusters, build_clusters
from raytracer2_tpu_torch.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2_tpu_torch.params import RTXDI_INVALID_LIGHT_INDEX, GConst
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.gbuffer import GBuffer, surface_from_gbuffer
from raytracer2_tpu_torch.render.shading import setup_visibility_ray
from raytracer2_tpu_torch.render.surface import (
    Surface, are_materials_similar, evaluate_brdf, get_surface_brdf_pdf,
    get_surface_brdf_sample)
from raytracer2_tpu_torch.restir.bridge import Bridge
from raytracer2_tpu_torch.scene.scene import Scene
from raytracer2_tpu_torch.utils import brdf as brdfm
from raytracer2_tpu_torch.utils.packing import linear_to_zcurve


@dataclasses.dataclass
class Tracers:
    """Closest-hit and any-hit queries over a scene.

    closest_hit(o, d, t_min, t_max, presorted=False) -> HitRecord;
    occluded(o, d, t_min, t_max, presorted=False) -> blocked bool mask.
    presorted=True rays are pixel tiles in screen order; presorted="shadow"
    (any hit only) are visibility rays in pixel Z-order. For the bundle
    walk and the pair sweep the clusters and walk tables are kept here
    (the pair sweep also keeps its PairScene, the walk its per-class
    kernel shapes). fallback_by_class counts, per class and summed over
    calls, what took the overflow fallback: for the bundle walk the
    bundles whose candidate union overflowed k_cand and re-traced at full
    length, for the pair sweep the rays of the traces in which some ray
    overlapped more than k_cand superclusters and that re-traced whole
    through the bundle walk."""

    closest_hit: Callable
    occluded: Callable | None = None
    shapes_by_class: dict | None = None
    clusters: Clusters | None = None
    tables: ct.WalkTables | None = None
    pair_scene: cp.PairScene | None = None
    scene_min: torch.Tensor | None = None
    scene_max: torch.Tensor | None = None
    fallback_by_class: dict = dataclasses.field(default_factory=dict)

    @property
    def fallback_bundles(self) -> int:
        return sum(self.fallback_by_class.values())

    def _count(self, cls, n: int) -> None:
        self.fallback_by_class[cls] = self.fallback_by_class.get(cls, 0) + n


# cluster_size 128 beats 64 at the 260k-triangle scale (the dense [rays, C]
# exact cull scales with C)
CLUSTER_SIZE = 128
K_CAND = 256  # candidate clusters per bundle before the overflow fallback
# the pair sweep's settings, the JAX make_tracers(backend="pairs") defaults
# (k_cand or 24, min(group or 16, 16)): superclusters per ray before the
# overflow fallback, clusters per supercluster
PAIR_K_CAND = 24
PAIR_GROUP = 16


def make_tracers(scene: Scene, backend: str = "auto") -> Tracers:
    """Traversal backends:
    - "auto" (default): the bundle walk; on a CUDA scene it launches the
      CUDA kernel, on a CPU scene the wrapper runs its plain version
    - "bundle_cuda": the bundle walk, and the scene must be on a CUDA device
    - "pairs": the pair sweep (ops/cuda_pairs.py: the binning and sweep
      kernels on a CUDA scene, their plain versions on a CPU scene); every
      ray class takes the same path (presorted is ignored), and a trace in
      which some ray overlaps more than PAIR_K_CAND superclusters re-traces
      whole through the bundle walk
    - "brute": the all-pairs oracle"""
    if scene.num_triangles < 2:
        backend = "brute"
    if backend == "brute":
        def brute(o, d, tmin, tmax, presorted=False):
            return intersect_brute_force(
                o, d, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
                scene.tri_geometry, scene.tri_primitive, tmin, tmax)

        def brute_occl(o, d, tmin, tmax, presorted=False):
            return occluded_brute_force(
                o, d, scene.tri_v0, scene.tri_edge1, scene.tri_edge2, tmin,
                tmax)

        return Tracers(closest_hit=brute, occluded=brute_occl)
    if backend == "bundle_cuda" and scene.device.type != "cuda":
        raise ValueError(f"backend 'bundle_cuda' needs a CUDA scene, "
                         f"this one is on {scene.device}")
    if backend not in ("auto", "bundle_cuda", "pairs"):
        raise ValueError(f"unknown backend {backend!r}")

    clusters = build_clusters(
        scene.host_tri_v0, scene.host_tri_edge1, scene.host_tri_edge2,
        cluster_size=CLUSTER_SIZE, device=scene.device)
    scene_min = clusters.aabb_min.amin(dim=0)
    scene_max = clusters.aabb_max.amax(dim=0)
    # the walk's scene tables, built once per scene rather than per trace
    # (the pair sweep's fallback walks them too)
    tables = ct.build_tables(clusters, scene.tri_geometry,
                             scene.tri_primitive)
    if backend == "pairs":
        return _pair_tracers(scene, clusters, tables, scene_min, scene_max)

    # per-class kernel shapes (raytracer2_tpu/render/app_bridge.py:119-143):
    # presorted pixel tiles take wide bundles, narrow groups and the
    # interval cull; incoherent bounces take 128-ray bundles, the exact
    # cull, and wider groups on big scenes; visibility rays in pixel
    # Z-order keep the incoherent shape and the exact cull but skip the
    # sort (an interval cull balloons on their scattered directions).
    # Small scenes keep the narrow shapes.
    big = clusters.num_clusters >= 512
    by_sort = {
        True: dict(bundle_size=256 if big else 128, group=4, k_cand=K_CAND,
                   cull="interval"),
        False: dict(bundle_size=128, group=8 if big else 4, k_cand=K_CAND,
                    cull="exact"),
        "shadow": dict(bundle_size=128, group=8 if big else 4,
                       k_cand=K_CAND, cull="exact"),
    }

    tracers = Tracers(
        closest_hit=None, shapes_by_class=by_sort, clusters=clusters,
        tables=tables, scene_min=scene_min, scene_max=scene_max)

    def closest(o, d, tmin, tmax, presorted=False):
        cls = bool(presorted)
        rec, n_fallback = ct.closest_hit_bundle(
            clusters, tables, o, d, tmin, tmax, scene_min, scene_max,
            presorted=cls, **by_sort[cls])
        tracers._count(cls, n_fallback)
        return rec

    def occl(o, d, tmin, tmax, presorted=False):
        cls = presorted if presorted == "shadow" else bool(presorted)
        kw = {k: v for k, v in by_sort[cls].items() if k != "cull"}
        if by_sort[cls]["cull"] != "exact":
            raise NotImplementedError(
                "the any-hit walk is ported with the exact cull only")
        blocked, n_fallback = ct.occluded_bundle(
            clusters, tables, o, d, tmin, tmax, scene_min, scene_max,
            presorted=bool(presorted), **kw)
        tracers._count(cls, n_fallback)
        return blocked

    tracers.closest_hit = closest
    tracers.occluded = occl
    return tracers


def _pair_tracers(scene: Scene, clusters: Clusters, tables: ct.WalkTables,
                  scene_min: torch.Tensor, scene_max: torch.Tensor
                  ) -> Tracers:
    """The pair sweep's tracers (JAX's make_tracers, backend="pairs")."""
    ps = cp.build_pair_scene(clusters, scene.tri_geometry,
                             scene.tri_primitive, group=PAIR_GROUP)
    tracers = Tracers(closest_hit=None, clusters=clusters, tables=tables,
                      pair_scene=ps, scene_min=scene_min,
                      scene_max=scene_max)

    def closest(o, d, tmin, tmax, presorted=False):
        rec, overflowed = cp.closest_hit_pairs(
            ps, clusters, tables, o, d, tmin, tmax, scene_min, scene_max,
            k_cand=PAIR_K_CAND)
        tracers._count(bool(presorted), o.shape[0] if overflowed else 0)
        return rec

    def occl(o, d, tmin, tmax, presorted=False):
        blocked, overflowed = cp.occluded_pairs(
            ps, clusters, tables, o, d, tmin, tmax, scene_min, scene_max,
            k_cand=PAIR_K_CAND)
        cls = presorted if presorted == "shadow" else bool(presorted)
        tracers._count(cls, o.shape[0] if overflowed else 0)
        return blocked

    tracers.closest_hit = closest
    tracers.occluded = occl
    return tracers


def get_light_sample_target_pdf(light_sample, surface: Surface
                                ) -> torch.Tensor:
    """RAB_GetLightSampleTargetPdfForSurface (bridge:478-500)."""
    live = light_sample.solid_angle_pdf > 0.0
    l = brdfm.normalize(light_sample.position - surface.world_pos)
    live &= brdfm.dot3(l, surface.geo_normal) > 0.0
    d = brdfm.lambert(surface.normal, -l)
    s = brdfm.ggx_times_ndotl(
        surface.view_dir, l, surface.normal,
        torch.clamp_min(surface.roughness, brdfm.K_MIN_ROUGHNESS),
        surface.specular_f0)
    s = torch.where((surface.roughness == 0.0)[..., None], 0.0, s)
    reflected = light_sample.radiance * (
        d[..., None] * surface.diffuse_albedo + s)
    pdf = brdfm.luminance(reflected) / torch.clamp_min(
        light_sample.solid_angle_pdf, 1e-30)
    return torch.where(live, pdf, 0.0)


def get_gi_sample_target_pdf(sample_position, sample_radiance,
                             surface: Surface) -> torch.Tensor:
    """RAB_GetGISampleTargetPdfForSurface (bridge:687-694)."""
    b = evaluate_brdf(surface, sample_position)
    reflected = sample_radiance * (
        b.demodulated_diffuse[..., None] * surface.diffuse_albedo + b.specular)
    return brdfm.luminance_rec709(reflected)


def make_bridge(scene: Scene, tracers: Tracers, gbuffer: GBuffer,
                prev_gbuffer: GBuffer, g_const: GConst, lights: LightInfo,
                geometry_to_light: torch.Tensor, local_pdf_mips,
                env_pdf_mips, neighbor_offsets: torch.Tensor, width: int,
                height: int) -> Bridge:
    """The RAB closure bundle for one frame (RtxdiApplicationBridge.glsl)."""
    view = g_const.view
    prev_view = g_const.prev_view
    isp = g_const.restir_di.initial_sampling_params
    invalid = RTXDI_INVALID_LIGHT_INDEX

    def get_gbuffer_surface(px, py, previous_frame):
        if previous_frame:
            return surface_from_gbuffer(prev_gbuffer, prev_view, px, py,
                                        width, height)
        return surface_from_gbuffer(gbuffer, view, px, py, width, height)

    def get_conservative_visibility(surface: Surface, sample_position):
        o, d, tmin, tmax = setup_visibility_ray(surface, sample_position)
        batch = tuple(tmin.shape)
        if len(batch) == 2 and batch[0] * batch[1] >= 4096:
            # a pixel-grid launch: the shadow rays start on the primary
            # surfaces, so 8x16 screen tiles (a reshape both ways) or the
            # Z-curve order make coherent bundles and the tracer skips its
            # sort
            h, w = batch
            packed = torch.cat([o, d, tmin[..., None], tmax[..., None]],
                               dim=-1)
            tiles = raysmod.tile_shape(w, h)
            if tiles is not None:
                th, tw = tiles
                packed = raysmod.tile_flatten(packed, tw, th)
            else:
                zidx, zinv = raysmod.zorder_permutation(w, h)
                packed = packed.reshape(-1, 8)[
                    torch.from_numpy(zidx).long().to(packed.device)]
            blocked = tracers.occluded(
                packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7],
                presorted="shadow")
            if tiles is not None:
                return ~raysmod.tile_unflatten(blocked, h, w, tw, th)
            return ~blocked[torch.from_numpy(zinv).long().to(
                blocked.device)].reshape(batch)
        blocked = tracers.occluded(o.reshape(-1, 3), d.reshape(-1, 3),
                                   tmin.reshape(-1), tmax.reshape(-1))
        return ~blocked.reshape(batch)

    def get_temporal_conservative_visibility(cur_surface, prev_surface,
                                             sample_position):
        # the previous surface against the current scene (bridge:242-245)
        return get_conservative_visibility(prev_surface, sample_position)

    def sample_polymorphic_light(light_info, surface, uv):
        return calc_sample(light_info, uv, surface.world_pos,
                           skybox=scene.skybox if g_const.environment
                           else None)

    def load_light_info(index, previous_frame):
        return gather_light(lights, torch.clamp_min(index, 0))

    def trace_ray_for_local_light(origins, directions, t_min, t_max):
        """(bridge:639-669): closest hit, then geometry -> light index."""
        batch = tuple(t_min.shape)
        hit = tracers.closest_hit(
            origins.reshape(-1, 3), directions.reshape(-1, 3),
            torch.broadcast_to(t_min, batch).reshape(-1),
            torch.broadcast_to(t_max, batch).reshape(-1))
        hit = type(hit)(*(f.reshape(batch) for f in hit))
        hit_anything = ~hit.missed
        geom = torch.where(hit_anything, hit.geometry_index, 0)
        base = geometry_to_light[geom]
        # one-sided emitters: a hit on the back face of an emissive
        # triangle identifies no light (the JAX package's fix of a leak
        # latent in the reference, app_bridge.py:442-448 there)
        tri = torch.clamp_min(hit.triangle_index, 0).long()
        tri_n = brdfm.cross(scene.tri_edge1[tri], scene.tri_edge2[tri])
        front = brdfm.dot3(directions.reshape(batch + (3,)), tri_n) < 0.0
        light_index = torch.where(
            (base != invalid) & hit_anything & front,
            (base + hit.primitive_id) & 0xFFFFFFFF, invalid)
        bary = brdfm.hit_uv_to_barycentric(torch.stack([hit.u, hit.v], -1))
        rand_xy = torch.where((light_index != invalid)[..., None],
                              brdfm.random_from_barycentric(bary), 0.0)
        return hit_anything, light_index, rand_xy

    def evaluate_local_light_source_pdf(light_index):
        """(bridge:420-434), with the JAX package's bias fix: the pdf of
        the active local sampling mode, uniform for mode 0 and the power
        texture for modes 1/2."""
        region = g_const.light_buffer_params.local_light_buffer_region
        if isp.local_light_sampling_mode == 0 or local_pdf_mips is None:
            return torch.full(light_index.shape,
                              1.0 / max(region.num_lights, 1),
                              device=light_index.device)
        x, y = linear_to_zcurve(light_index)
        return evaluate_pdf_texture(local_pdf_mips, x, y)

    def evaluate_environment_map_sampling_pdf(direction):
        """(bridge:397-418)."""
        if env_pdf_mips is None or isp.environment_map_importance_sampling == 0:
            return torch.ones(direction.shape[:-1], device=direction.device)
        uv = brdfm.direction_to_equirect_uv(direction)
        h, w = env_pdf_mips[0].shape
        return evaluate_pdf_texture(env_pdf_mips, (uv[..., 0] * w).long(),
                                    (uv[..., 1] * h).long())

    return Bridge(
        get_gbuffer_surface=get_gbuffer_surface,
        get_light_sample_target_pdf=get_light_sample_target_pdf,
        get_gi_sample_target_pdf=get_gi_sample_target_pdf,
        get_conservative_visibility=get_conservative_visibility,
        get_temporal_conservative_visibility=(
            get_temporal_conservative_visibility),
        are_materials_similar=are_materials_similar,
        sample_polymorphic_light=sample_polymorphic_light,
        load_light_info=load_light_info,
        get_surface_brdf_sample=get_surface_brdf_sample,
        get_surface_brdf_pdf=get_surface_brdf_pdf,
        trace_ray_for_local_light=trace_ray_for_local_light,
        evaluate_local_light_source_pdf=evaluate_local_light_source_pdf,
        evaluate_environment_map_sampling_pdf=(
            evaluate_environment_map_sampling_pdf),
        neighbor_offsets=neighbor_offsets,
        viewport=(width, height))
