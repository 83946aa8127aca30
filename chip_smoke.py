#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracer2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's reference-mode frame at full size: the procedural ladder
corridor (~260k triangles, bench.py's headline scene) at 1920x1080, through
create_renderer / init_frame_state / render_frame and render_reference. The
phases, each of which raises on failure:

1. device  - a CUDA device is required; no CPU run.
2. build   - nvcc builds the walk kernel from raytracer2_tpu_torch/csrc.
3. scene   - the ladder scene, its clusters and the tracers on the card.
4. kernel  - the walk kernel against its plain torch version on one
             262,144-ray batch of each ray class (pixel tiles and BRDF
             bounces), winner codes bit for bit, with both times.
5. oracle  - 4,096 rays of each class against the brute-force tracer.
6. frames  - two reference-mode frames and two render_reference frames at
             bench's ladder settings; the walk must have launched.

The last two lines are one JSON object about the kernels and the result
line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from raytracer2_tpu.models import procedural as proc  # noqa: E402
from raytracer2_tpu.ops import native  # noqa: E402
from raytracer2_tpu.scene import gltf  # noqa: E402
from raytracer2_tpu_torch.ops import _build  # noqa: E402
from raytracer2_tpu_torch.ops import cuda_traverse as ct  # noqa: E402
from raytracer2_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_brute_force)
from raytracer2_tpu_torch.params import default_gconst  # noqa: E402
from raytracer2_tpu_torch.render import frame as fr  # noqa: E402
from raytracer2_tpu_torch.render import rays as raysmod  # noqa: E402
from raytracer2_tpu_torch.render.reference import (  # noqa: E402
    render_reference)
from raytracer2_tpu_torch.render.surface import (  # noqa: E402
    get_surface_brdf_sample, surface_from_hit)
from raytracer2_tpu_torch.scene.camera import default_camera  # noqa: E402
from raytracer2_tpu_torch.scene.scene import build_scene  # noqa: E402
from raytracer2_tpu_torch.utils import rng as rtrng  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
BATCH = 1 << 18  # render_reference's chunk_pixels: one trace batch
ORACLE_RAYS = 4096
T_MIN, T_MAX = 0.001, 100000.0  # refrence.rgen:27, BACKGROUND_DEPTH
KERNEL_SOURCE = "raytracer2_tpu_torch/csrc/bundle_walk.cu"
REPLACES = "raytracer2_tpu/ops/pallas_traverse.py:1323"


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)
    return torch.device("cuda", 0)


def phase_build() -> None:
    b = _build.build()
    usage = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", library=b.path.name, seconds=f"{b.seconds:.2f}",
        ptxas=repr(" | ".join(usage)))
    _build.library()


def phase_scene(dev: torch.device):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "ladder.glb"
        proc.write_glb(path, proc.corridor_glb(
            segments=24, pillars_per_side=12, lat=34, lon=53))
        scene = build_scene(gltf.load_file(path), device=dev)
    renderer = fr.create_renderer(scene, WIDTH, HEIGHT, backend="auto")
    torch.cuda.synchronize()
    cam = default_camera(window_size=(WIDTH, HEIGHT), position=(0, 4, 90),
                         direction=(0, 0, 1))
    g = default_gconst(cam.planar_view_constants(),
                       scene.num_emissive_triangles, refrence_mode=1)
    tr = renderer.tracers
    log("scene", triangles=scene.num_triangles,
        clusters=tr.clusters.num_clusters,
        cluster_builder="native_sah" if native.available() else "morton",
        shapes=json.dumps({str(k): v for k, v in tr.shapes_by_class.items()},
                          separators=(",", ":")),
        seconds=f"{time.perf_counter() - t0:.1f}")
    return scene, renderer, g


def main_path_batches(scene, renderer, g):
    """The first Z-order chunk's primary rays (the pixel-tile class) and
    the BRDF bounce rays drawn from their hits (the bounce class), as
    render_reference builds them."""
    dev = scene.device
    zidx, _ = raysmod.zorder_permutation(WIDTH, HEIGHT)
    lin = torch.from_numpy(zidx[:BATCH]).long().to(dev)
    px, py = lin % WIDTH, lin // WIDTH
    primary = raysmod.setup_primary_ray(px, py, g.view)
    tn = torch.full((BATCH,), T_MIN, device=dev)
    tx = torch.full((BATCH,), T_MAX, device=dev)
    hit = renderer.tracers.closest_hit(primary.origin, primary.direction,
                                       tn, tx, presorted=True)
    surface, _ = surface_from_hit(scene, primary.origin, primary.direction,
                                  hit)
    state = rtrng.init_random_sampler(px, py, g.frame + 13)
    direction, _, _ = get_surface_brdf_sample(surface, state)
    alive = ~hit.missed
    return {
        "pixel_tiles": (True, primary.origin, primary.direction, tn, tx),
        "bounces": (False, surface.world_pos, direction, tn,
                    torch.where(alive, tx, -1.0)),
    }


def _prep(tracers, presorted, o, d, tn, tx):
    cfg = tracers.shapes_by_class[presorted]
    if cfg["cull"] == "interval":
        prep = ct.prepare_bundles_interval(tracers.clusters, o, d, tn, tx,
                                           cfg["bundle_size"], cfg["k_cand"])
    else:
        prep = ct.prepare_bundles_exact(
            tracers.clusters, o, d, tn, tx, tracers.scene_min,
            tracers.scene_max, cfg["bundle_size"], presorted, cfg["k_cand"])
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    return (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tracers.tables.wald_rows), cfg["group"], prep


def _median_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_kernel(renderer, batches) -> dict:
    tracers = renderer.tracers
    out = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0, "classes": {}}
    for cls, (presorted, o, d, tn, tx) in batches.items():
        args, group, prep = _prep(tracers, presorted, o, d, tn, tx)
        code = ct.walk_closest(*args, group=group)
        want = ct.walk_closest_reference(*args, group=group)
        torch.cuda.synchronize()
        mismatches = int((code != want).sum())
        err = int((code.long() - want.long()).abs().max())
        ms = _median_ms(lambda: ct.walk_closest(*args, group=group))
        plain_ms = _median_ms(
            lambda: ct.walk_closest_reference(*args, group=group))
        hits = int((code != ct.MISS_CODE).sum())
        log("kernel", cls=cls, rays=o.shape[0], bundles=args[3].shape[0],
            bundle_size=args[0].shape[0] // args[3].shape[0], group=group,
            cand_mean=f"{args[3].float().mean().item():.2f}",
            cand_max=int(args[3].max()),
            overflowed_bundles=int(prep.overflowed.sum()), hits=hits,
            mismatches=mismatches, kernel_ms=f"{ms:.3f}",
            plain_ms=f"{plain_ms:.3f}")
        if mismatches:
            raise RuntimeError(f"{cls}: kernel and plain version disagree "
                               f"on {mismatches} winner codes")
        if hits == 0:
            raise RuntimeError(f"{cls}: the batch hit nothing")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["classes"][cls] = {"ms": ms, "plain_ms": plain_ms,
                               "mismatches": mismatches}
    return out


def phase_oracle(scene, renderer, batches) -> None:
    for cls, (presorted, o, d, tn, tx) in batches.items():
        sl = slice(0, ORACLE_RAYS)
        got = renderer.tracers.closest_hit(o[sl], d[sl], tn[sl], tx[sl],
                                           presorted=presorted)
        ref = intersect_brute_force(
            o[sl], d[sl], scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
            scene.tri_geometry, scene.tri_primitive, tn[sl], tx[sl])
        differ = got.triangle_index != ref.triangle_index
        tie = differ & (got.missed == ref.missed) & (
            (got.t - ref.t).abs() <= 1e-5 * ref.t.abs())
        bad = int((differ & ~tie).sum())
        log("oracle", cls=cls, rays=ORACLE_RAYS,
            hits=int((~ref.missed).sum()), same_triangle=int((~differ).sum()),
            t_ties=int(tie.sum()), disagree=bad)
        if bad:
            raise RuntimeError(f"{cls}: {bad} hits disagree with the "
                               "brute-force oracle beyond t-ties")


def _check_image(name, img, display: bool) -> None:
    finite = bool(torch.isfinite(img).all())
    lo, hi, mean = (float(img.min()), float(img.max()), float(img.mean()))
    log("image", name=name, shape=tuple(img.shape), finite=finite,
        min=f"{lo:.6g}", max=f"{hi:.6g}", mean=f"{mean:.6g}")
    if not finite or lo < 0.0 or img.shape != (HEIGHT, WIDTH, 3):
        raise RuntimeError(f"{name}: not a finite, non-negative "
                           f"{HEIGHT}x{WIDTH}x3 image")
    if display and hi <= 0.0:
        raise RuntimeError(f"{name}: the display image is all black")


def phase_frames(scene, renderer, g) -> int:
    tracers = renderer.tracers
    ct.walk_closest.launches = 0
    tracers.fallback_bundles = 0
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    spp, bounces = 12, 5  # render_frame's reference defaults
    for f in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, img = fr.render_frame(renderer, g.replace(frame=f), state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log("render_frame", frame=f, spp=spp, bounces=bounces,
            seconds=f"{sec:.3f}",
            nominal_mrays_per_s=f"{WIDTH * HEIGHT * spp * bounces / sec / 1e6:.3f}",
            walk_launches=ct.walk_closest.launches,
            fallback_bundles=tracers.fallback_bundles)
        _check_image("render_frame display", img, display=True)
    _check_image("diffuse_lighting", state.diffuse_lighting, display=False)

    spp, bounces = 8, 5  # bench.py's ladder reference cell
    for f in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, live = render_reference(
            scene, g.replace(frame=f + 1), WIDTH, HEIGHT,
            max_bounces=bounces, max_samples=spp,
            trace_fn=tracers.closest_hit, with_ray_count=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log("render_reference", frame=f + 1, spp=spp, bounces=bounces,
            seconds=f"{sec:.3f}",
            nominal_mrays_per_s=f"{WIDTH * HEIGHT * spp * bounces / sec / 1e6:.3f}",
            live_rays=live, walk_launches=ct.walk_closest.launches,
            fallback_bundles=tracers.fallback_bundles)
        _check_image("render_reference radiance", img, display=False)
    launches = ct.walk_closest.launches
    if launches <= 0:
        raise RuntimeError("the main path never launched the walk kernel")
    return launches


def main() -> None:
    dev = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    scene, renderer, g = phase_scene(dev)
    batches = main_path_batches(scene, renderer, g)
    kernel = phase_kernel(renderer, batches)
    phase_oracle(scene, renderer, batches)
    launches = phase_frames(scene, renderer, g)
    log("memory", peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    print(json.dumps({"kernels": [{
        "name": "walk_closest", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "classes": kernel["classes"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
