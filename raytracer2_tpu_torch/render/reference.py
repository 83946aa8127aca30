"""Brute-force reference path tracer — the correctness oracle. Port of
raytracer2_tpu/render/reference.py (src/shaders/lighting_passes/
refrence.rgen): maxSamples diffuse paths of maxBounces bounces per pixel,
environment termination, emission accumulated at every hit. Inactive lanes
stop contributing AND stop consuming RNG draws, so each pixel's random
sequence is the sequential shader's.

Pixels run in Z-order chunks of `chunk_pixels`, so every trace sees
screen-tile-coherent batches; the camera ray is traced once per chunk
(presorted, it is the same for every sample) and reused across samples;
bounce batches give terminated lanes t_max = -1 so they never hit and
never widen a bundle; with compact_dead_lanes a bounce batch of at least
2,048 lanes, at most half of them live, traces only its live half.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import torch

from raytracer2_tpu_torch.ops.intersect import (
    INVALID_INDEX, HitRecord, intersect_brute_force)
from raytracer2_tpu_torch.params import BACKGROUND_DEPTH, GConst
from raytracer2_tpu_torch.render import rays as raysmod
from raytracer2_tpu_torch.render.surface import (
    get_surface_brdf_sample, surface_from_hit)
from raytracer2_tpu_torch.scene.scene import Scene, get_environment_radiance
from raytracer2_tpu_torch.utils import readback
from raytracer2_tpu_torch.utils import rng as rtrng
from raytracer2_tpu_torch.utils.brdf import dot3

MAX_BOUNCES = 5  # (ref: refrence.rgen:16)
MAX_SAMPLES = 12  # (ref: refrence.rgen:17)
COMPACT_MIN_LANES = 2048  # smaller bounce batches never compact

# (origins, directions, t_min, t_max, presorted=False) -> HitRecord
TraceFn = Callable[..., HitRecord]


def make_brute_force_tracer(scene: Scene, chunk: int = 512) -> TraceFn:
    """Closest-hit tracer closure over the scene's world-space triangles
    (the `trace()` wrapper, bridge:74-81, minus the driver)."""

    def trace(origins, directions, t_min, t_max, presorted=False):
        return intersect_brute_force(
            origins, directions, scene.tri_v0, scene.tri_edge1,
            scene.tri_edge2, scene.tri_geometry, scene.tri_primitive,
            t_min, t_max, chunk=chunk)

    return trace


def _trace_compact(trace_fn: TraceFn, o, d, tn, tx) -> HitRecord:
    """A bounce batch with its dead lanes (t_max < 0) compacted away (JAX's
    tf_compact): where at most half of n >= COMPACT_MIN_LANES lanes are
    live, the first n // 2 lanes of a stable live-first order are traced
    and scattered back, the rest filled as a miss at t 0; else the whole
    batch is traced. Dead lanes take no part in the frame, so the image is
    the uncompacted one's bit for bit."""
    n = o.shape[0]
    h = n // 2
    dead = tx < 0.0
    if n < COMPACT_MIN_LANES or readback.item((~dead).sum(),
                                              "live_lanes") > h:
        return trace_fn(o, d, tn, tx)
    perm = torch.argsort(dead.to(torch.uint8), stable=True)[:h]
    rec = trace_fn(o[perm], d[perm], tn[perm], tx[perm])

    def back(leaf, fill):
        out = torch.full((n,) + leaf.shape[1:], fill, dtype=leaf.dtype,
                         device=leaf.device)
        out[perm] = leaf
        return out

    return HitRecord(t=back(rec.t, 0.0), u=back(rec.u, 0.0),
                     v=back(rec.v, 0.0),
                     geometry_index=back(rec.geometry_index, INVALID_INDEX),
                     primitive_id=back(rec.primitive_id, 0),
                     triangle_index=back(rec.triangle_index, -1))


@lru_cache(maxsize=8)
def _zorder_on(width: int, height: int, device):
    """The Z-curve permutation and its inverse as int64 tensors on
    `device`, uploaded once per shape, not every frame."""
    zidx, zinv = raysmod.zorder_permutation(width, height)
    return (readback.upload(zidx, device, torch.long),
            readback.upload(zinv, device, torch.long))


def render_reference(
    scene: Scene,
    g_const: GConst,
    width: int,
    height: int,
    max_bounces: int = MAX_BOUNCES,
    max_samples: int = MAX_SAMPLES,
    trace_fn: TraceFn | None = None,
    textures_enabled: bool | None = None,
    with_ray_count: bool = False,
    chunk_pixels: int = 1 << 18,
    emission_facing: str = "double",
    compact_dead_lanes: bool = False,
):
    """Render the reference image on the scene's device; returns linear
    radiance [H, W, 3] (and, with with_ray_count=True, the number of live
    rays traced as a Python int; the nominal count is W*H*spp*bounces).

    textures_enabled: None reads g_const.textures. emission_facing:
    "double" adds hit emission regardless of facing (refrence.rgen:38);
    "front" only on front-face hits (the RMSE gate's matched-transport
    oracle). compact_dead_lanes traces each bounce batch through
    _trace_compact (the same image bit for bit)."""
    if trace_fn is None:
        trace_fn = make_brute_force_tracer(scene)
    if textures_enabled is None:
        textures_enabled = bool(g_const.textures)
    environment = g_const.environment
    dev = scene.device

    zidx_t, zinv_t = _zorder_on(width, height, dev)
    px_img, py_img = raysmod.pixel_grid(width, height, device=dev)
    px_all = px_img.reshape(-1)[zidx_t]
    py_all = py_img.reshape(-1)[zidx_t]
    n_img = px_all.shape[0]

    # pad to whole chunks with dummy (0, 0) pixels whose lanes never trace
    n = min(chunk_pixels, n_img)
    pad = (-n_img) % n
    if pad:
        zeros = torch.zeros(pad, dtype=px_all.dtype, device=dev)
        px_all = torch.cat([px_all, zeros])
        py_all = torch.cat([py_all, zeros])
    valid_all = torch.arange(px_all.shape[0], device=dev) < n_img

    t_min = torch.full((n,), 0.001, device=dev)  # refrence.rgen:27
    t_max = torch.full((n,), BACKGROUND_DEPTH, device=dev)
    live_rays = torch.zeros((), dtype=torch.int64, device=dev)
    chunks = []
    for c0 in range(0, px_all.shape[0], n):
        px, py = px_all[c0:c0 + n], py_all[c0:c0 + n]
        valid = valid_all[c0:c0 + n]
        # RAB_InitRandomSampler(pixel, pass=1) -> frame + 13
        rng_state = rtrng.init_random_sampler(px, py, g_const.frame + 13)
        primary = raysmod.setup_primary_ray(px, py, g_const.view)
        hit0 = trace_fn(primary.origin, primary.direction, t_min,
                        torch.where(valid, t_max, -1.0), presorted=True)
        surface0, emission0 = surface_from_hit(
            scene, primary.origin, primary.direction, hit0,
            textures_enabled=textures_enabled)

        radiance = torch.zeros((n, 3), device=dev)
        for _ in range(max_samples):
            throughput = torch.ones((n, 3), device=dev)
            active = valid
            origin, direction = primary.origin, primary.direction
            for bounce in range(max_bounces):
                if with_ray_count:
                    live_rays += active.sum()
                if bounce == 0:
                    hit, surface, emission = hit0, surface0, emission0
                else:
                    lane_tmax = torch.where(active, t_max, -1.0)
                    hit = (_trace_compact(trace_fn, origin, direction,
                                          t_min, lane_tmax)
                           if compact_dead_lanes else
                           trace_fn(origin, direction, t_min, lane_tmax))
                    surface, emission = surface_from_hit(
                        scene, origin, direction, hit,
                        textures_enabled=textures_enabled)

                missed = hit.missed
                env = get_environment_radiance(scene, direction, environment)
                # miss: add env once then terminate (refrence.rgen:32-36)
                radiance = radiance + torch.where(
                    (active & missed)[..., None], throughput * env, 0.0)
                # hit: add emission, attenuate (refrence.rgen:38-39)
                emit = emission
                if emission_facing == "front":
                    front = dot3(direction, surface.normal) < 0.0
                    emit = torch.where(front[..., None], emission, 0.0)
                take = active & ~missed
                radiance = radiance + torch.where(
                    take[..., None], throughput * emit, 0.0)
                throughput = torch.where(
                    take[..., None], throughput * surface.diffuse_albedo,
                    throughput)

                # next bounce dir; only active hit lanes consume RNG draws
                new_dir, _, advanced = get_surface_brdf_sample(
                    surface, rng_state)
                rng_state = rtrng.RngState(
                    seed=rng_state.seed,
                    index=torch.where(take, advanced.index, rng_state.index))
                direction = torch.where(take[..., None], new_dir, direction)
                origin = torch.where(take[..., None], surface.world_pos,
                                     origin)
                active = take
        chunks.append(radiance)

    radiance = torch.cat(chunks)[:n_img]
    img = (radiance[zinv_t] / max_samples).reshape(height, width, 3)
    if with_ray_count:
        return img, int(live_rays)
    return img


def render_reference_jit(scene: Scene, g_const: GConst, width: int,
                         height: int, max_bounces: int = MAX_BOUNCES,
                         max_samples: int = MAX_SAMPLES):
    """JAX's jitted entry point, the same signature: the reference image
    through the brute-force tracer. The port has no trace step to compile
    (torch runs eagerly), so this is one call of render_reference."""
    return render_reference(scene, g_const, width, height, max_bounces,
                            max_samples)
