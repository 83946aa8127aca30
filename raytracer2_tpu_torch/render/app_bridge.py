"""Traversal backends and the RAB_* bridge, port of
raytracer2_tpu/render/app_bridge.py: Tracers and make_tracers (closest hit
and any hit per ray class), make_bridge, which wires scene, tracers,
G-buffers and light tables into the closure bundle the ReSTIR library
reads, and suggest_k_cand, the per-class candidate budgets a camera's rays
need.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from raytracer2_tpu_torch.lights.pdf_texture import evaluate_pdf_texture
from raytracer2_tpu_torch.lights.polymorphic import (
    LightInfo, calc_sample, gather_light)
from raytracer2_tpu_torch.ops import cuda_pairs as cp
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops import traverse as lbvh
from raytracer2_tpu_torch.ops.bvh import BVH, build_lbvh, max_depth
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
from raytracer2_tpu_torch.utils.readback import guarded_scalar


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
    through the bundle walk. union_max(o, d, t_min, t_max, presorted=False)
    (the bundle walk only) gives a batch's largest per-bundle candidate
    union as a 0-d device tensor: the k_cand its class needs to truncate
    nothing. The lbvh walk keeps its BVH and sums its steps and host
    checks over calls in walk_stats."""

    closest_hit: Callable
    occluded: Callable | None = None
    union_max: Callable | None = None
    shapes_by_class: dict | None = None
    clusters: Clusters | None = None
    tables: ct.WalkTables | None = None
    pair_scene: cp.PairScene | None = None
    bvh: BVH | None = None
    walk_stats: lbvh.WalkStats | None = None
    scene_min: torch.Tensor | None = None
    scene_max: torch.Tensor | None = None
    fallback_by_class: dict = dataclasses.field(default_factory=dict)

    @property
    def k_cand_by_class(self) -> dict | None:
        """The candidate budget of each ray class (None without classes)."""
        if self.shapes_by_class is None:
            return None
        return {cls: cfg["k_cand"]
                for cls, cfg in self.shapes_by_class.items()}

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


def make_tracers(scene: Scene, backend: str = "auto",
                 k_cand_per_class: dict | None = None,
                 bvh: BVH | None = None) -> Tracers:
    """Traversal backends:
    - "auto" (default): the bundle walk; on a CUDA scene it launches the
      CUDA kernel, on a CPU scene the wrapper runs its plain version
    - "bundle_cuda": the bundle walk, and the scene must be on a CUDA device
    - "pairs": the pair sweep (ops/cuda_pairs.py: the binning and sweep
      kernels on a CUDA scene, their plain versions on a CPU scene); every
      ray class takes the same path (presorted is ignored), and a trace in
      which some ray overlaps more than PAIR_K_CAND superclusters re-traces
      whole through the bundle walk
    - "lbvh": the per-ray stack walk over an LBVH (ops/bvh.py,
      ops/traverse.py; torch ops, no kernel), built from the scene's
      triangles on its device unless `bvh` is given; presorted is ignored
    - "brute": the all-pairs oracle
    k_cand_per_class sets the bundle walk's candidate budget per ray
    class, keyed as suggest_k_cand returns it: True (pixel tiles), False
    (bounces), "shadow" (visibility rays); None values keep K_CAND."""
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
    if backend == "lbvh":
        return _lbvh_tracers(scene, bvh)
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
    for cls, val in (k_cand_per_class or {}).items():
        if cls in by_sort and val is not None:
            by_sort[cls]["k_cand"] = int(val)

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

    def umax(o, d, tmin, tmax, presorted=False):
        cfg = by_sort[presorted if presorted == "shadow" else bool(presorted)]
        return ct.union_max_bundle(
            clusters, o, d, tmin, tmax, scene_min, scene_max,
            bundle_size=cfg["bundle_size"], cull=cfg["cull"],
            presorted=bool(presorted))

    tracers.closest_hit = closest
    tracers.occluded = occl
    tracers.union_max = umax
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


def _lbvh_tracers(scene: Scene, bvh: BVH | None) -> Tracers:
    """The LBVH walk's tracers (JAX's make_tracers, backend="lbvh")."""
    if bvh is None:
        bvh = build_lbvh(scene.tri_v0, scene.tri_edge1, scene.tri_edge2)
    depth = max_depth(bvh)
    if depth > lbvh.STACK_SIZE:
        raise ValueError(
            f"LBVH depth {depth} exceeds the traversal stack "
            f"({lbvh.STACK_SIZE}); overflow would silently drop subtrees "
            "(ADVICE r1) — deepen STACK_SIZE or rebalance the tree")
    stats = lbvh.WalkStats()

    def closest(o, d, tmin, tmax, presorted=False):
        return lbvh.closest_hit(
            bvh, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
            scene.tri_geometry, scene.tri_primitive, o, d, tmin, tmax,
            stats=stats)

    def occl(o, d, tmin, tmax, presorted=False):
        return lbvh.occluded(bvh, scene.tri_v0, scene.tri_edge1,
                             scene.tri_edge2, o, d, tmin, tmax, stats=stats)

    return Tracers(closest_hit=closest, occluded=occl, bvh=bvh,
                   walk_stats=stats)


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
                height: int, row_base: int = 0) -> Bridge:
    """The RAB closure bundle for one frame (RtxdiApplicationBridge.glsl).
    row_base maps global pixel rows into (halo-padded) G-buffer row tiles
    under row sharding."""
    view = g_const.view
    prev_view = g_const.prev_view
    isp = g_const.restir_di.initial_sampling_params
    invalid = RTXDI_INVALID_LIGHT_INDEX

    def get_gbuffer_surface(px, py, previous_frame):
        if previous_frame:
            return surface_from_gbuffer(prev_gbuffer, prev_view, px, py,
                                        width, height, row_base=row_base)
        return surface_from_gbuffer(gbuffer, view, px, py, width, height,
                                    row_base=row_base)

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
        return gather_light(lights, index)

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


def suggest_k_cand(renderer, view=None, margin: float = 1.25,
                   quantum: int = 64, k_floor: int = 96,
                   n_incoherent: int = 65536,
                   timeout: float = 60.0) -> dict | None:
    """The per-class candidate budgets (make_tracers' k_cand_per_class)
    that trace with no truncation, from the largest per-bundle candidate
    union of (a) a seeded incoherent batch (origins in the scene's box,
    random directions: the proxy for bounce and visibility rays) and, given
    a view, (b) this camera's primary rays in tile order (the pixel-tile
    class), each times `margin`, rounded up to `quantum`, at least
    `k_floor`. None when the tracers have no probe (brute force, the pair
    sweep), when the budgets already match, or when the read-back stalls
    past `timeout` seconds (utils/readback.py; an error in it raises). The
    overflow fallback stays the safety net for rays beyond the margin.

    Rebuild the tracers with make_tracers(scene, backend=...,
    k_cand_per_class=suggestion)."""
    tr = renderer.tracers
    if tr.union_max is None or tr.k_cand_by_class is None:
        return None
    scene = renderer.scene
    if scene.host_tri_v0 is None or scene.num_triangles < 2:
        return None
    dev = scene.device
    lo = scene.host_tri_v0.min(axis=0)
    hi = scene.host_tri_v0.max(axis=0)

    rng = np.random.default_rng(0)
    o_inc = rng.uniform(lo, hi, (n_incoherent, 3)).astype(np.float32)
    v = rng.normal(size=(n_incoherent, 3)).astype(np.float32)
    d_inc = v / np.linalg.norm(v, axis=1, keepdims=True)
    maxes = [tr.union_max(
        torch.from_numpy(o_inc).to(dev), torch.from_numpy(d_inc).to(dev),
        torch.full((n_incoherent,), 1e-3, device=dev),
        torch.full((n_incoherent,), 1e5, device=dev), presorted=False)]

    if view is not None:
        w, h = renderer.width, renderer.height
        px, py = raysmod.pixel_grid(w, h, device=dev)
        pr = raysmod.setup_primary_ray(px.reshape(-1), py.reshape(-1), view)
        tiles = raysmod.tile_shape(w, h)
        if tiles is not None:
            zidx = raysmod.tile_permutation(w, h, tiles[1], tiles[0])
        else:
            zidx, _ = raysmod.zorder_permutation(w, h)
        zidx = torch.from_numpy(zidx).long().to(dev)
        maxes.append(tr.union_max(pr.origin[zidx], pr.direction[zidx],
                                  pr.t_min, pr.t_max, presorted=True))

    host = guarded_scalar(torch.stack(maxes), timeout=timeout)
    if host is None:
        return None

    def size(mx):
        return max(int(np.ceil(mx * margin / quantum)) * quantum, k_floor)

    k_inc = size(int(host[0]))
    sug = {False: k_inc, "shadow": k_inc}
    if view is not None:
        sug[True] = size(int(host[1]))
    cur = tr.k_cand_by_class
    if all(sug[c] == cur.get(c) for c in sug):
        return None
    return sug
