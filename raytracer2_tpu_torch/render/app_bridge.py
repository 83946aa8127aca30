"""Traversal backends over a scene, port of the Tracers part of
raytracer2_tpu/render/app_bridge.py. The bridge (make_bridge: RAB_*
closures, visibility rays, the material row gather) comes with the DI
slice (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.ops.cluster import Clusters, build_clusters
from raytracer2_tpu_torch.ops.intersect import intersect_brute_force
from raytracer2_tpu_torch.scene.scene import Scene


@dataclasses.dataclass
class Tracers:
    """Closest-hit query over a scene.

    closest_hit(o, d, t_min, t_max, presorted=False) -> HitRecord; rays
    presorted=True are pixel tiles in screen Z-order. For the bundle walk
    the clusters, tables and per-class kernel shapes are kept here, and
    fallback_bundles counts the bundles (summed over calls) whose
    candidate union overflowed k_cand and re-traced at full length."""

    closest_hit: Callable
    shapes_by_class: dict | None = None
    clusters: Clusters | None = None
    tables: ct.WalkTables | None = None
    scene_min: torch.Tensor | None = None
    scene_max: torch.Tensor | None = None
    fallback_bundles: int = 0


# cluster_size 128 beats 64 at the 260k-triangle scale (the dense [rays, C]
# exact cull scales with C)
CLUSTER_SIZE = 128
K_CAND = 256  # candidate clusters per bundle before the overflow fallback


def make_tracers(scene: Scene, backend: str = "auto") -> Tracers:
    """Traversal backends:
    - "auto" (default): the bundle walk; on a CUDA scene it launches the
      CUDA kernel, on a CPU scene the wrapper runs its plain version
    - "bundle_cuda": the bundle walk, and the scene must be on a CUDA device
    - "brute": the all-pairs oracle"""
    if scene.num_triangles < 2:
        backend = "brute"
    if backend == "brute":
        def brute(o, d, tmin, tmax, presorted=False):
            return intersect_brute_force(
                o, d, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
                scene.tri_geometry, scene.tri_primitive, tmin, tmax)

        return Tracers(closest_hit=brute)
    if backend == "bundle_cuda" and scene.device.type != "cuda":
        raise ValueError(f"backend 'bundle_cuda' needs a CUDA scene, "
                         f"this one is on {scene.device}")
    if backend not in ("auto", "bundle_cuda"):
        raise ValueError(f"unknown backend {backend!r}")

    clusters = build_clusters(
        scene.host_tri_v0, scene.host_tri_edge1, scene.host_tri_edge2,
        cluster_size=CLUSTER_SIZE, device=scene.device)
    scene_min = clusters.aabb_min.amin(dim=0)
    scene_max = clusters.aabb_max.amax(dim=0)

    # per-class kernel shapes (raytracer2_tpu/render/app_bridge.py:119-143):
    # presorted pixel tiles take wide bundles, narrow groups and the
    # interval cull; incoherent bounces take 128-ray bundles, the exact
    # cull, and wider groups on big scenes. Small scenes keep the narrow
    # shapes.
    big = clusters.num_clusters >= 512
    by_sort = {
        True: dict(bundle_size=256 if big else 128, group=4, k_cand=K_CAND,
                   cull="interval"),
        False: dict(bundle_size=128, group=8 if big else 4, k_cand=K_CAND,
                    cull="exact"),
    }

    # the walk's scene tables, built once per scene rather than per trace
    tables = ct.build_tables(clusters, scene.tri_geometry,
                             scene.tri_primitive)
    tracers = Tracers(
        closest_hit=None, shapes_by_class=by_sort, clusters=clusters,
        tables=tables, scene_min=scene_min, scene_max=scene_max)

    def closest(o, d, tmin, tmax, presorted=False):
        rec, n_fallback = ct.closest_hit_bundle(
            clusters, tables, o, d, tmin, tmax, scene_min, scene_max,
            presorted=bool(presorted), **by_sort[bool(presorted)])
        tracers.fallback_bundles += n_fallback
        return rec

    tracers.closest_hit = closest
    return tracers
