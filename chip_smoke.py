#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracer2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three frame paths at full size on the procedural ladder
corridor (~260k triangles, bench.py's headline scene) at 1920x1080, through
create_renderer / init_frame_state / render_frame (and render_reference):
the flagship ReSTIR DI+GI frame (bench.py's pipeline frame: the default
GConst plus DI; GI temporal and spatial off), the ReSTIR DI frame of
bench.py's DI validation config (4 local-light + 1 BRDF candidates, final
visibility, accumulation; GI off) and the reference-mode frame, through the
default bundle-walk backend; then the flagship and DI frames again through
the pair-sweep backend (create_renderer(..., backend="pairs")); and the
flagship frame under a 2048x1024 EXR skybox, on checkerboard fields and
stopped after each pass (the per-pass split); the lbvh backend
(create_renderer(..., backend="lbvh"), torch ops), the app CLI
(app.main) and the terminal viewer (viewer.run_interactive); and the
frame row-sharded over torch.distributed ranks (parallel/mesh.py). Six
hand-written CUDA kernels carry them: the closest-hit and any-hit walks
(B1, B2), the exact cull's nearest box and bundle union (B3, B4), and the
pair engine's sweep (B5) and stable counting sort (B6). The phases, each of
which raises on failure:

1. device             - a CUDA device is required; no CPU run.
2. build              - nvcc builds every kernel from raytracer2_tpu_torch/csrc.
3. scene              - the ladder scene, its clusters (and which cluster
                        builder ran) and the tracers on the card; then
                        pairs-scene (19) and occupancy: resident blocks per
                        SM, registers and shared bytes per block of
                        walk_closest at each closest-hit class's bundle
                        size, of walk_occluded at the visibility class's, of
                        nearest_box and bundle_union, of pair_sweep at the
                        pair scene's S_pad and of bin_scatter's count, scan
                        and scatter kernels at its bins.
4. kernel             - walk_closest against its plain torch version on the
                        reference path's 262,144-ray batch of each
                        closest-hit class (pixel tiles, BRDF bounces), winner
                        codes bit for bit.
5. oracle             - 4,096 rays of each of those classes against the
                        brute-force tracer.
6. capture            - one DI frame that keeps a copy of the inputs of
                        each trace call's walk and cull launches (G-buffer,
                        BRDF candidate, visibility: 2,073,600 rays each).
7. kernel-occlude     - on those inputs, walk_closest (G-buffer, BRDF
                        candidate) and walk_occluded (visibility) against
                        their plain versions, bit for bit.
8. oracle-occlude     - 4,096 visibility rays from the middle of the screen
                        through occluded_bundle against the brute-force
                        any-hit oracle; rounding ties (the walk's answer lies
                        between the oracle's with the segment ends and
                        triangle edges moved in and out by the Wald test's
                        float32 bound) are counted apart.
9. di-frames          - two DI frames; both walks must have launched. Then
                        di-breakdown: one more with each trace and walk
                        timed, and one under torch.profiler (busy/idle).
10. flagship-capture  - one flagship DI+GI frame that keeps the inputs of
                        each B3 and B4 launch of its three bounce-class
                        traces (the DI BRDF candidate, the GI BRDF rays, the
                        secondary surfaces' BRDF candidate), and of the
                        first B1 launch of those and of its G-buffer; then
                        kernel: walk_closest against its plain version on
                        those four batches, bit for bit.
11. kernel-cull       - on those inputs (and B4 on the DI frame's visibility
                        batch), nearest_box and bundle_union against their
                        plain versions, bit for bit, with NaN rays and the
                        signed zeros of the union table counted.
12. flagship-frames   - three flagship frames; all four kernels but the
                        any-hit walk (the flagship frame casts no visibility
                        ray) must have launched. Then flagship-breakdown: one
                        more with each trace split into B3, the cand0 sort,
                        B4, the ranking, the walk and the decode, and one
                        under torch.profiler (busy/idle).
13. gi-resampling     - two frames of the goldens' configuration (GI temporal
                        and spatial resampling on), checked finite. Then:
    di-resampling     - four DI frames (the DI config with temporal and
                        spatial resampling, ray-traced bias correction and
                        the boiling filter; the camera moves 0.1 a frame);
                        B1-B4 must have launched, 5 visibility batches a
                        frame; B2 launches per frame, the median frame;
                        one more frame keeps the inputs of B2 and B4 on its
                        temporal and first spatial visibility batch, held
                        to their plain versions bit for bit
                        (kernel-occlude, kernel-cull); one frame each of
                        modes 1, 2 and bias modes 0-2, finite.
    regir             - create_renderer(regir=True): the ReGIR grid (16^3
                        cells of 128 lights) built on the card, its seconds
                        and filled share; three DI frames with local-light
                        sampling mode 2 (B1, B2, B4 launched).
    k-cand            - suggest_k_cand(renderer, view): the probe's two
                        maxima (B3 and B4 launched, equal through the plain
                        cull versions), the suggested budgets, the seconds;
                        a flagship frame through tracers with those
                        budgets: its fallback bundles, the pixels that
                        differ from the default frame 0, each trace's hits
                        against the default tracers' up to key ties.
    lbvh-build        - build_lbvh on the card from the ladder's triangles,
                        timed; its depth (at most 31, JAX's build on a CPU),
                        validate_bvh, and its five arrays bit-equal to the
                        port's build of the host triangles on the CPU; then
                        create_renderer(backend="lbvh").
    oracle-lbvh       - lbvh's closest hit on 4,096 rays of each class of
                        phase 4's batches against the brute-force tracer,
                        its any hit on phase 8's visibility rays against the
                        any-hit oracle (ties counted apart), and each whole
                        262,144-ray batch against the bundle walk, timed: a
                        hit that differs is a key tie or equals the
                        brute-force oracle; the walk's steps and host
                        checks per call.
    lbvh-frames       - two flagship frames and one DI frame through the
                        lbvh backend, timed, each trace timed, the walk's
                        steps per trace; no kernel may launch; the pixels
                        that differ from the bundle frames of the same index.
    app               - app.main (python -m raytracer2_tpu_torch.app) on the
                        ladder GLB at 1920x1080 for 4 frames (the same
                        camera, an --animate file turning GI off at frame 2,
                        --checkpoint), then --resume for 2: every PNG read
                        back by utils/png.read_png, metrics.json's keys, the
                        k_cand budgets logged, B1, B3 and B4 launched inside
                        the app's frames; its p50_ms beside the flagship
                        frames' median.
    viewer            - viewer.run_interactive for 3 flagship frames at
                        256x144 on a pseudo-terminal, "w1" typed before each
                        frame: every half-block frame written, the camera
                        moved.
14. skybox            - a 2048x1024 procedural sky written as a float16 PIZ
                        EXR and read back, exact to float16 (skybox-exr,
                        taken before the DI frames: a worker process
                        started with the run does this pure-Python host
                        work while only the kernel checks run, and is
                        stopped once its result is in); the ladder
                        scene under that sky and create_renderer on the
                        card: the environment pdf's size, the seconds, the
                        share of environment RIS words that are filled.
15. checkerboard-     - one flagship frame with environment=1 on checkerboard
    capture             field 1 under the sky, keeping the inputs of the
                        first B1, B3 and B4 launch of each bounce trace, and
                        one DI-config frame on field 1 keeping those of B2
                        and B4 on its visibility trace; each bounce and
                        visibility trace must cast H*W/2 rays; then
                        kernel-checkerboard: B1, B3 and B4 (and B2, B4 on
                        the visibility batch) against their plain versions
                        on those half-grid batches.
16. checkerboard-     - four sky frames on fields 1, 2, 1, 2 (bench.py's
    frames              at_frame), two full-grid sky frames and two DI-config
                        frames on fields 1, 2; B1, B3 and B4 (and B2 in the
                        DI frames) must have launched; every display lit.
17. flagship-passes   - each FRAME_PASSES prefix of the full-grid flagship
                        frame (no sky) and of its checkerboard variant,
                        5 synchronised runs each taken in turns, their
                        median, spread and signed differences; and, in
                        the same turns, whole frames with each pass
                        synchronised and timed inside the frame: the
                        per-pass split.
18. frames            - one reference-mode render_frame and one
                        render_reference frame; walk_closest must have
                        launched.
19. pairs-scene       - (right after scene) the pair-sweep tracers on the
                        same scene: superclusters, lanes, table bytes; then
                        oracle-pairs, after oracle and oracle-occlude: the
                        same 4,096 rays of each class through them against
                        the brute-force oracles.
20. pairs-capture     - one flagship and one DI frame through the pairs
                        backend that hold every launch of B5 and B6 (every
                        262,144-ray batch) to its plain version, and keep
                        the inputs of the first launch in each trace call
                        and each trace call's rays.
21. kernel-pairs      - on those first batches, pair_sweep and bin_scatter
                        against their plain versions, bit for bit and timed
                        (with the capture's tally of every batch; each
                        kernel and torch.argsort timed as one call, B6 also
                        as one L2-cold CUDA graph replay, graph_ms),
                        and bin_scatter on 2^22 ids in 256 bins (the probe's
                        size); then
                        pairs-ties: each kept trace through both backends,
                        every hit that differs a t-tie (a blocked flag that
                        differs, a rounding tie as in oracle-occlude), and
                        the most superclusters one ray of it overlaps; then
                        pairs-no-overflow: the flagship frame's four traces
                        and the DI visibility trace through the pair engine
                        alone at k_cand = K, the smallest multiple of 8 at
                        or above that count: no ray overflows, the answers
                        equal the bundle walk's up to the same ties, and
                        each trace's time (median of 3), its B5 and B6
                        time, and the bundle backend's trace and walk time
                        on the same rays.
22. pairs-frames      - two flagship frames and one DI frame through the
                        pairs backend; B5 and B6 must have launched; the
                        rays that took the overflow fallback per class, and
                        the pixels that differ from the bundle backend's
                        frames of the same index. Then pairs-breakdown: one
                        more flagship frame with each trace split into the
                        slab test, the binning (B6 inside it), the sweep
                        (B5) and the decode, and one under torch.profiler.
23. sharded           - the frame row-sharded over torch.distributed ranks
                        (parallel/dryrun.py), with the dry run's flagship
                        configuration (GI temporal and spatial on): (a) one
                        NCCL rank, two frames; (b) two gloo ranks sharing
                        the card, 540 rows each, two frames and one
                        checkerboard frame with DI temporal resampling.
                        Every gathered frame against render_frame's
                        unsharded one of the same index: more than 95% of
                        the pixels bit-exact, a mean |diff| below 1e-3 (the
                        JAX dry run's bar), the pixels beyond 2e-3 logged;
                        each rank's frame seconds, halo telemetry and
                        launches (B1, B3, B4 must launch in every rank);
                        each run joined against a deadline.

Each kernel check prints its time, its plain version's and its bound (the
least time the card could take: the larger of the bytes the kernel must
move over the memory rate and the FP32 operations its data needs over the
FP32 rate). The last lines are the run's wall seconds, the card's name and
power limit, one JSON object about the kernels and the result line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --dump-bin DIR

also saves each B6 input that kernel-pairs checks into DIR (torch.save, one
file per trace and one for the probe), the inputs of tools/bin_scatter_ab.py.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import logging
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from raytracer2_tpu_torch import app, viewer  # noqa: E402
from raytracer2_tpu_torch.models import procedural as proc  # noqa: E402
from raytracer2_tpu_torch.ops import _build, binning, cull, native  # noqa: E402
from raytracer2_tpu_torch.ops import cuda_pairs as cp  # noqa: E402
from raytracer2_tpu_torch.ops import cuda_traverse as ct  # noqa: E402
from raytracer2_tpu_torch.ops.bvh import (  # noqa: E402
    build_lbvh, max_depth, validate_bvh)
from raytracer2_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_brute_force, moller_trumbore, occluded_brute_force)
from raytracer2_tpu_torch.parallel import dryrun  # noqa: E402
from raytracer2_tpu_torch.params import (  # noqa: E402
    BACKGROUND_DEPTH, LightBufferRegion, default_gconst)
from raytracer2_tpu_torch.render import frame as fr  # noqa: E402
from raytracer2_tpu_torch.render import app_bridge  # noqa: E402
from raytracer2_tpu_torch.render import rays as raysmod  # noqa: E402
from raytracer2_tpu_torch.render.postprocess import to_srgb_u8  # noqa: E402
from raytracer2_tpu_torch.render.reference import (  # noqa: E402
    render_reference)
from raytracer2_tpu_torch.render.surface import (  # noqa: E402
    get_surface_brdf_sample, surface_from_hit)
from raytracer2_tpu_torch.restir.regir import (  # noqa: E402
    presample_regir_grid)
from raytracer2_tpu_torch.scene import exr, gltf  # noqa: E402
from raytracer2_tpu_torch.scene.camera import default_camera  # noqa: E402
from raytracer2_tpu_torch.scene.scene import build_scene  # noqa: E402
from raytracer2_tpu_torch.utils import rng as rtrng  # noqa: E402
from raytracer2_tpu_torch.utils.png import read_png  # noqa: E402
from raytracer2_tpu_torch.utils.profiler import (  # noqa: E402
    PassTimer, count_frame_rays)
from tools import bin_scatter_ab  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
# bench.py's ladder corridor (bench.py:130-135) and the camera that sees it
LADDER = dict(segments=24, pillars_per_side=12, lat=34, lon=53)
CAMERA_POS, CAMERA_DIR = (0, 4, 90), (0, 0, 1)
BATCH = 1 << 18  # render_reference's chunk_pixels: one trace batch
ORACLE_RAYS = 4096
T_MIN, T_MAX = 0.001, 100000.0  # refrence.rgen:27, BACKGROUND_DEPTH
TIE_REL = 1e-5  # a closest hit within this relative t of another ties
IMAGE_TOL = 2e-3  # the goldens' rtol=atol
# two engines' closest hits tie when their t agree above the bits a packed
# key drops (the pair key 11 low mantissa bits, the walk's 10): the key
# orders such hits by lane slot, which the engines lay out differently
KEY_TIE_REL = 2.0 ** -12
# the float32 rounding bound of one Wald test: this many units of 2^-24
# times the sum of the absolute terms of its affines
WALD_ROUNDING = 8 * 2.0 ** -24

# NVIDIA H100 SXM data sheet: HBM3 rate and FP32 rate outside the tensor
# cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one (ray, triangle) Wald test: 6 multiplies, 14 FMAs
# (two operations each), 4 adds, 1 divide and 6 compares (the closest-hit
# walk has one compare fewer and a packed-key update instead)
WALD_TEST_OPS = 45
# FP32 operations of one (live ray, box) slab test of the cull kernels: 6
# subtracts, 6 multiplies, 6 mins/maxes per axis pair, 4 across the axes,
# 3 compares of the hit test, the clamp at 0 and the reduction's compare
# (the hit test's t_max >= 0 depends on the ray alone: the kernels make it
# once per ray, and cull_bound counts only the rays that pass it)
SLAB_TEST_OPS = 27
FLAGSHIP_FRAMES = 3
PAIRS_FLAGSHIP_FRAMES = 2
PROBE_IDS, PROBE_BINS = 1 << 22, 256  # scripts/binning_ab.py's probe size
DUMP_BIN: Path | None = None  # --dump-bin: where check_bin saves B6's inputs
SKY_HEIGHT = 1024  # the skybox phase's equirect sky is 2 * SKY_HEIGHT wide
CHECKERBOARD_FRAMES = 4  # fields 1, 2, 1, 2
SKY_FULL_FRAMES = 2
CHECKERBOARD_DI_FRAMES = 2  # fields 1, 2
PASS_REPEATS = 5  # synchronised runs of each frame prefix
NO_OVERFLOW_REPEATS = 3  # synchronised traces per backend in pairs-no-overflow
RESAMPLING_FRAMES = 4  # DI resampling frames of the moving camera
RESAMPLING_STEP = 0.1  # the camera's x step per resampling frame
REGIR_FRAMES = 3
# JAX's build_lbvh of the ladder's triangles on a CPU gives this depth
LBVH_MAX_DEPTH = 31
LBVH_FIELDS = ("left", "right", "aabb_min", "aabb_max", "tri_order")
LBVH_FLAGSHIP_FRAMES = 2
# the sharded phase: (a) one NCCL rank, (b) gloo ranks sharing the card
# (NCCL refuses two ranks on one device), each rank joined by this deadline
SHARDED_RUNS = {"nccl": (1, 2, 0), "gloo": (2, 2, 1)}  # ranks, frames, cb
SHARDED_TIMEOUT_S = 300.0
SHARDED_COUNTED = ("walk_closest", "nearest_box", "bundle_union")
APP_FRAMES, APP_RESUME_FRAMES = 4, 2
APP_METRICS = {"traversal_overflow", "frames", "p50_ms", "mean_ms", "fps",
               "telemetry"}
VIEWER_SIZE, VIEWER_FRAMES = (256, 144), 3
# the flagship frame's bounce-class traces, in the order the frame casts
# them (the G-buffer's pixel tiles take the interval cull, not B3/B4)
FLAGSHIP_BOUNCES = ("di_brdf_candidate", "gi_brdf_rays",
                    "secondary_brdf_candidate")
# the flagship frame's walk batches B1 is held to: its G-buffer's pixel
# tiles and its three bounce traces
FLAGSHIP_WALKS = ("flagship_gbuffer",) + tuple(
    f"flagship_{b}" for b in FLAGSHIP_BOUNCES)
# the kept pairs traces that pairs-no-overflow runs at a k_cand that keeps
# every overlap: the flagship frame's four and the DI frame's visibility
NO_OVERFLOW_TRACES = tuple(f"pairs_flagship_{b}" for b in (
    "gbuffer",) + FLAGSHIP_BOUNCES) + ("pairs_di_visibility",)

KERNELS = {
    "walk_closest": dict(
        source="raytracer2_tpu_torch/csrc/bundle_walk.cu",
        replaces="raytracer2_tpu/ops/pallas_traverse.py:1323"),
    "walk_occluded": dict(
        source="raytracer2_tpu_torch/csrc/bundle_occlude.cu",
        replaces="raytracer2_tpu/ops/pallas_traverse.py:1488"),
    "nearest_box": dict(
        source="raytracer2_tpu_torch/csrc/cull.cu",
        replaces="raytracer2_tpu/ops/pallas_cull.py:106"),
    "bundle_union": dict(
        source="raytracer2_tpu_torch/csrc/cull.cu",
        replaces="raytracer2_tpu/ops/pallas_cull.py:128"),
    "pair_sweep": dict(
        source="raytracer2_tpu_torch/csrc/pair_sweep.cu",
        replaces="raytracer2_tpu/ops/pallas_pairs.py:115"),
    "bin_scatter": dict(
        source="raytracer2_tpu_torch/csrc/binning.cu",
        replaces="raytracer2_tpu/ops/pallas_binning.py:56"),
}
WALKS = ("walk_closest", "walk_occluded")
CULLS = ("nearest_box", "bundle_union")
PAIR_KERNELS = ("pair_sweep", "bin_scatter")
KERNEL_MODULES = {"walk_closest": ct, "walk_occluded": ct,
                  "nearest_box": cull, "bundle_union": cull,
                  "pair_sweep": cp, "bin_scatter": binning}


def launch_count(name: str) -> int:
    return getattr(KERNEL_MODULES[name], name).launches


T_START = time.perf_counter()  # the run's clock, which each log line reads


def log(phase: str, **fields) -> None:
    print(f"[{phase} +{time.perf_counter() - T_START:.1f}s] "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, smi=repr(smi))
    return torch.device("cuda", 0), smi


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
        proc.write_glb(path, proc.corridor_glb(**LADDER))
        model = gltf.load_file(path)
    scene = build_scene(model, device=dev)
    renderer = fr.create_renderer(scene, WIDTH, HEIGHT, backend="auto")
    torch.cuda.synchronize()
    cam = default_camera(window_size=(WIDTH, HEIGHT), position=CAMERA_POS,
                         direction=CAMERA_DIR)
    view = cam.planar_view_constants()
    tr = renderer.tracers
    log("scene", triangles=scene.num_triangles,
        lights=renderer.scene_lights.num_local_lights,
        clusters=tr.clusters.num_clusters,
        cluster_builder="native_sah" if native.available() else "morton",
        shapes=json.dumps({str(k): v for k, v in tr.shapes_by_class.items()},
                          separators=(",", ":")),
        seconds=f"{time.perf_counter() - t0:.1f}")
    return scene, renderer, view, model


def reference_gconst(scene, view):
    return default_gconst(view, scene.num_emissive_triangles, refrence_mode=1)


def di_gconst(scene, view):
    """bench.py's ReSTIR DI validation config ("restir-di 4NEE+1BRDF
    finalvis", bench.py:667-676): DI on, GI off, accumulation, 4 local-light
    candidates from the RIS tiles and 1 BRDF candidate, final visibility."""
    g = default_gconst(view, scene.num_emissive_triangles,
                       enable_restir_di=1, enable_restir_gi=0,
                       enable_accumulation=1, correct_specular_accumulation=1)
    di = g.restir_di
    isp = dataclasses.replace(di.initial_sampling_params,
                              num_primary_local_light_samples=4)
    shp = dataclasses.replace(di.shading_params, enable_final_visibility=1)
    return g.replace(restir_di=dataclasses.replace(
        di, initial_sampling_params=isp, shading_params=shp))


def flagship_gconst(renderer, view, **overrides):
    """bench.py's pipeline frame (bench.py:266-272): the default GConst
    plus DI; GI on, GI temporal and spatial off."""
    return default_gconst(view, renderer.scene_lights.num_local_lights,
                          enable_restir_di=1, **overrides)


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


def _prep(tracers, cls, o, d, tn, tx):
    cfg = tracers.shapes_by_class[cls]
    if cfg["cull"] == "interval":
        prep = ct.prepare_bundles_interval(tracers.clusters, o, d, tn, tx,
                                           cfg["bundle_size"], cfg["k_cand"])
    else:
        prep = ct.prepare_bundles_exact(
            tracers.clusters, o, d, tn, tx, tracers.scene_min,
            tracers.scene_max, cfg["bundle_size"], bool(cls), cfg["k_cand"])
    rays8 = torch.cat([prep.o, prep.d, prep.tn[:, None], prep.tx[:, None]],
                      dim=1).contiguous()
    return (rays8, prep.cand_idx, prep.cand_t, prep.cand_count,
            tracers.tables.wald_rows), cfg["group"], prep


def _plain_ms(fn) -> float:
    """A plain version's time in ms: one call of fn between CUDA events.
    The caller has made one call on the same inputs just before (the one
    whose outputs it compares), which is the warm-up; the plain walks and
    culls take up to 10 s a call, so one timed call is all the run
    affords."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _median_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn in ms, after one warm-up call."""
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


def _bound_share(kernel: str, cls: str, bound_ms: float, ms: float) -> float:
    """bound_ms / ms; raises where a time is not positive or the kernel
    would beat its own bound (a measurement or a bound that is wrong)."""
    if not ms > 0:
        raise RuntimeError(f"{kernel} ({cls}): timed {ms} ms")
    share = bound_ms / ms
    if share > 1.0:
        raise RuntimeError(f"{kernel} ({cls}): {ms} ms beats its bound of "
                           f"{bound_ms} ms")
    return share


def lane_real(tracers) -> torch.Tensor:
    """[C, S_pad] bool: True on the lanes that hold a real triangle."""
    sp = tracers.tables.wald_rows.shape[-1]
    return (tracers.tables.meta_rows[:, 12] >= 0).reshape(-1, sp)


def walk_bound(args, group: int, work: ct.WalkWork, real, kw) -> dict:
    """The least time the card could take for one walk call on these
    inputs: the larger of (bytes it must move) / HBM rate and (FP32
    operations its data needs) / FP32 rate. Bytes: rays read once, the
    candidate entries the bundles walk, the Wald coefficients (12 floats)
    of each real triangle of each distinct cluster walked, one i32 written
    per ray. Operations: WALD_TEST_OPS per (ray, real triangle) test over
    the steps each bundle takes, as the plain version counts them (padding
    lanes left out; an any-hit ray counts up to its first hit)."""
    rays8, cand_idx, _, cand_count, _ = args
    walked = torch.minimum(work.steps * group, cand_count.long())
    mask = (torch.arange(cand_idx.shape[1], device=cand_idx.device)[None, :]
            < walked[:, None])
    distinct = torch.unique(cand_idx[mask]).long()
    tris = int(real[distinct].sum())
    n_rays = rays8.shape[0]
    nbytes = (n_rays * 8 * 4 + cand_count.numel() * 4 + int(mask.sum()) * 8
              + tris * 12 * 4 + n_rays * 4)
    ops = int(work.ray_lanes) * WALD_TEST_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    # what the bundles stage in all (mostly from L2), for comparison: each
    # walked cluster's lanes up to its lane count
    lanes = int(kw["lanes"].count[cand_idx[mask].long()].long().sum())
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "steps": int(work.steps.sum()),
            "clusters_walked": int(distinct.numel()),
            "triangles_walked": tris, "staged_bytes": lanes * 12 * 4}


def check_walk(kernel: str, cls: str, args, group: int, real,
               **kw) -> dict:
    """One walk kernel against its plain version on one batch: outputs
    bit for bit, both times (CUDA events: the kernel's median of 5; the
    plain version's one call without the work count, after the call that
    gives the outputs and counts the work the bound reads) and the bound.
    kw: the kernel's own table argument (lanes). Raises on any mismatch or
    on a batch that tests nothing."""
    walk = getattr(ct, kernel)
    reference = getattr(ct, f"{kernel}_reference")
    got = walk(*args, group=group, **kw)
    want, work = reference(*args, group=group, lane_real=real)
    plain_ms = _plain_ms(lambda: reference(*args, group=group))
    ms = _median_ms(lambda: walk(*args, group=group, **kw))
    bound = walk_bound(args, group, work, real, kw)
    rays8, _, _, cand_count, _ = args
    mismatches = int((got != want).sum())
    if kernel == "walk_closest":
        hits = int((got != ct.MISS_CODE).sum())
        outcome = {"hits": hits}
        trivial = hits == 0
    else:
        live = int((rays8[:, 7] > rays8[:, 6]).sum())
        blocked = int(got.sum())
        outcome = {"live_rays": live, "blocked": blocked,
                   "blocked_share": f"{blocked / max(live, 1):.4f}"}
        trivial = blocked in (0, live)
    share = _bound_share(kernel, cls, bound["bound_ms"], ms)
    log("kernel-occlude" if kernel == "walk_occluded" else "kernel",
        kernel=kernel, cls=cls, rays=rays8.shape[0],
        bundles=cand_count.shape[0],
        bundle_size=rays8.shape[0] // cand_count.shape[0], group=group,
        cand_mean=f"{cand_count.float().mean().item():.2f}",
        cand_max=int(cand_count.max()), **outcome, mismatches=mismatches,
        kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
        bound_share=f"{share:.3f}",
        steps=bound["steps"], steps_max=int(work.steps.max()),
        clusters_walked=bound["clusters_walked"],
        triangles_walked=bound["triangles_walked"],
        mbytes=f"{bound['bytes'] / 1e6:.2f}",
        gops=f"{bound['ops'] / 1e9:.3f}",
        staged_mbytes=f"{bound['staged_bytes'] / 1e6:.2f}")
    if mismatches:
        raise RuntimeError(f"{kernel} ({cls}): kernel and plain version "
                           f"disagree on {mismatches} of {rays8.shape[0]} "
                           "rays")
    if trivial:
        raise RuntimeError(f"{kernel} ({cls}): the batch hits nothing or "
                           "everything, it tests nothing")
    return {"ms": ms, "plain_ms": plain_ms, "mismatches": mismatches,
            "max_abs_err": int((got.long() - want.long()).abs().max()),
            **bound}


def _totals(classes: dict) -> dict:
    out = {k: sum(c[k] for c in classes.values())
           for k in ("ms", "plain_ms", "bound_ms", "mismatches")}
    out["max_abs_err"] = max(c["max_abs_err"] for c in classes.values())
    by_bytes = sum(c["bound_ms"] for c in classes.values()
                   if c["bound_by"] == "bytes")
    out["bound_by"] = ("bytes" if by_bytes >= out["bound_ms"] - by_bytes
                       else "operations")
    out["classes"] = classes
    return out


def cull_bound(args, out: torch.Tensor) -> dict:
    """The least time the card could take for one cull call on these
    inputs: the larger of (bytes) / HBM rate and (FP32 operations) / FP32
    rate. Bytes: the rays and the boxes read once, the output written once.
    Operations: SLAB_TEST_OPS per (live ray, box) slab test; a ray with
    t_max < 0 (dead, or padding) needs none."""
    rays8, amin = args[0], args[1]
    live = int((rays8[:, 7] >= 0.0).sum())
    nbytes = rays8.numel() * 4 + amin.numel() * 2 * 4 + out.numel() * 4
    ops = live * amin.shape[0] * SLAB_TEST_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "live_rays": live}


def check_cull(kernel: str, cls: str, args) -> dict:
    """One cull kernel against its plain version on one batch: outputs bit
    for bit (the union table compared as int32 bits, its +0 and -0 counted
    and any sign-of-zero difference reported apart), both times (CUDA
    events: the kernel's median of 5, the plain version's one call after
    the call that gives the outputs) and the bound. Raises on any
    mismatch, a -0 in the kernel's union table, or a batch that tests
    nothing."""
    fn = getattr(cull, kernel)
    reference = getattr(cull, f"{kernel}_reference")
    got = fn(*args)
    want = reference(*args)
    plain_ms = _plain_ms(lambda: reference(*args))
    ms = _median_ms(lambda: fn(*args))
    bound = cull_bound(args, got)
    rays8, c = args[0], args[1].shape[0]
    if kernel == "nearest_box":
        mismatches = int((got != want).sum())
        max_abs = int((got.long() - want.long()).abs().max())
        overlapped = int((want < c).sum())
        outcome = {"rays_overlapping": overlapped}
        trivial = overlapped == 0
    else:
        gb, wb = got.view(torch.int32), want.view(torch.int32)
        mismatches = int((gb != wb).sum())
        zero = want == 0.0
        finite = torch.isfinite(want)
        diff = torch.where(finite & torch.isfinite(got), got - want, 0.0)
        max_abs = float(diff.abs().max())
        outcome = {
            "finite_share": f"{float(finite.float().mean()):.6f}",
            "plus_zero": int((zero & ~torch.signbit(want)).sum()),
            "minus_zero": int((zero & torch.signbit(want)).sum()),
            "zero_sign_differences": int((zero & (got == 0.0)
                                          & (gb != wb)).sum()),
            "kernel_minus_zero": int(((got == 0.0)
                                      & torch.signbit(got)).sum())}
        trivial = not bool(finite.any())
    share = _bound_share(kernel, cls, bound["bound_ms"], ms)
    log("kernel-cull", kernel=kernel, cls=cls, rays=rays8.shape[0],
        live_rays=bound["live_rays"],
        nan_rays=int(torch.isnan(rays8).any(dim=1).sum()), boxes=c,
        out_shape=tuple(got.shape), **outcome, mismatches=mismatches,
        kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
        bound_share=f"{share:.3f}",
        mbytes=f"{bound['bytes'] / 1e6:.2f}",
        gops=f"{bound['ops'] / 1e9:.3f}")
    if mismatches:
        raise RuntimeError(f"{kernel} ({cls}): kernel and plain version "
                           f"disagree on {mismatches} values")
    if outcome.get("kernel_minus_zero"):
        raise RuntimeError(f"{kernel} ({cls}): the union table holds -0")
    if trivial:
        raise RuntimeError(f"{kernel} ({cls}): the batch overlaps no box, "
                           "it tests nothing")
    return {"ms": ms, "plain_ms": plain_ms, "mismatches": mismatches,
            "max_abs_err": max_abs, **bound}


def phase_kernel(renderer, batches) -> dict:
    tracers = renderer.tracers
    real = lane_real(tracers)
    classes = {}
    for cls, (presorted, o, d, tn, tx) in batches.items():
        args, group, _ = _prep(tracers, presorted, o, d, tn, tx)
        classes[cls] = check_walk("walk_closest", cls, args, group, real,
                                  lanes=tracers.tables.lanes)
    return classes


def phase_occupancy(renderer, renderer_p) -> dict:
    """B1 at each closest-hit class's bundle size, B2 at the visibility
    class's, B3 and B4 at their blocks, B5 at the pair scene's S_pad and
    B6's three kernels (count, scan, scatter) at its bins (superclusters
    + 1): resident blocks per SM, threads, registers and shared bytes per
    block (the kernels' occupancy entry points)."""
    tracers = renderer.tracers
    sp = tracers.tables.wald_rows.shape[-1]
    ps = renderer_p.tracers.pair_scene
    out = {"walk_closest": {}, "walk_occluded": {}, "nearest_box": {
        "all": _build.occupancy("rt2_nearest_box_occupancy")},
        "bundle_union": {
            "all": _build.occupancy("rt2_bundle_union_occupancy")},
        "pair_sweep": {"all": _build.occupancy("rt2_pair_sweep_occupancy",
                                               ps.s_pad)},
        "bin_scatter": {
            name: _build.occupancy("rt2_bin_scatter_occupancy", i,
                                   ps.num_superclusters + 1)
            for i, name in enumerate(("count", "scan", "scatter"))}}
    for cls, cfg in tracers.shapes_by_class.items():
        if cls == "shadow":
            out["walk_occluded"]["visibility"] = _build.occupancy(
                "rt2_walk_occluded_occupancy", cfg["bundle_size"], sp)
        else:
            name = "pixel_tiles" if cls else "bounces"
            out["walk_closest"][name] = _build.occupancy(
                "rt2_walk_closest_occupancy", cfg["bundle_size"], sp)
    for kernel, by_cls in out.items():
        for cls, occ in by_cls.items():
            log("occupancy", kernel=kernel, cls=cls, **occ,
                warps_per_sm=occ["blocks_per_sm"] * occ["threads"] // 32)
    return out


def phase_oracle(scene, renderer, batches, phase: str = "oracle") -> None:
    for cls, (presorted, o, d, tn, tx) in batches.items():
        sl = slice(0, ORACLE_RAYS)
        got = renderer.tracers.closest_hit(o[sl], d[sl], tn[sl], tx[sl],
                                           presorted=presorted)
        ref = intersect_brute_force(
            o[sl], d[sl], scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
            scene.tri_geometry, scene.tri_primitive, tn[sl], tx[sl])
        differ = got.triangle_index != ref.triangle_index
        tie = differ & (got.missed == ref.missed) & (
            (got.t - ref.t).abs() <= TIE_REL * ref.t.abs())
        bad = int((differ & ~tie).sum())
        log(phase, cls=cls, rays=ORACLE_RAYS,
            hits=int((~ref.missed).sum()), same_triangle=int((~differ).sum()),
            t_ties=int(tie.sum()), disagree=bad)
        if bad:
            raise RuntimeError(f"{cls}: {bad} hits disagree with the "
                               "brute-force oracle beyond t-ties")


class _Patch:
    """Replaces a callable attribute with hook(original, *args, **kwargs);
    restore() puts the original back. Other attributes (a walk's launch
    count) read and write through to the original."""

    _OWN = ("owner", "attr", "hook", "inner")

    def __init__(self, owner, attr: str, hook):
        self.owner, self.attr, self.hook = owner, attr, hook
        self.inner = getattr(owner, attr)
        setattr(owner, attr, self)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    def __call__(self, *args, **kwargs):
        return self.hook(self.inner, *args, **kwargs)

    def restore(self) -> None:
        setattr(self.owner, self.attr, self.inner)


class TraceLog:
    """Hooks the tracers' two queries and, for the bundle backend, the two
    walks and the two cull passes, or with pairs=True the pair engine's
    sweep and binning. It counts the visibility rays (the "shadow" class)
    and how many are blocked. Between start() and stop() it names each
    trace call (prefix + "gbuffer", the bounce names in call order, prefix
    + "visibility") and keeps, by name, a copy of the inputs of the first
    launch of each hooked kernel in that call (the main path's own batch,
    not a fallback re-trace), and ORACLE_RAYS visibility rays from the
    middle of the screen. With pairs=True (or keep_traces=True) it also
    keeps each trace call's rays; with pairs=True it holds every launch of
    B5 and B6 in a trace call (every 262,144-ray batch) to the kernel's
    plain version on the same inputs,
    keeping per (name, kernel) the batches, mismatches and hits (keys
    below MISS_KEY) in `checked`. It also keeps the ray count of each
    named trace call (`trace_rays`). It launches no kernel itself; restore()
    takes its hooks out."""

    def __init__(self, tracers, pairs: bool = False,
                 keep_traces: bool = False):
        self.keep = False
        self.walks = {}  # name -> (walk name, args, group)
        self.culls = {}  # (name, cull kernel) -> args
        self.pair_kernels = {}  # (name, kernel) -> (args, kwargs)
        self.checked = {}  # (name, kernel) -> [batches, mismatches, hits]
        self.traces = {}  # name -> (o, d, t_min, t_max, presorted)
        self.trace_rays = {}  # name -> rays of its first trace call
        self.oracle_rays = None
        self.rays = self.blocked = 0
        self._cls = None
        self._pairs = pairs
        self._keep_traces = pairs or keep_traces
        self._prefix, self._bounces, self._n_bounce = "", (), 0
        self._shadows, self._n_shadow = (), 0
        self.patches = [_Patch(tracers, "closest_hit", self._closest),
                        _Patch(tracers, "occluded", self._occluded)]
        if pairs:
            self.patches += [_Patch(cp, "pair_sweep", self._pair_kernel),
                             _Patch(binning, "bin_scatter",
                                    self._pair_kernel)]
        else:
            self.patches += [_Patch(ct, "walk_closest", self._walk),
                             _Patch(ct, "walk_occluded", self._walk),
                             _Patch(cull, "nearest_box", self._cull),
                             _Patch(cull, "bundle_union", self._cull)]

    def restore(self) -> None:
        for patch in reversed(self.patches):
            patch.restore()

    def start(self, prefix: str, bounces, shadows=()) -> None:
        """Name the trace calls from here on: prefix + "gbuffer", the
        bounces in call order (the last name repeats) and the visibility
        calls as `shadows` in call order (the last repeats), or all
        prefix + "visibility" where none are given."""
        self.keep = True
        self._prefix, self._bounces, self._n_bounce = prefix, bounces, 0
        self._shadows, self._n_shadow = shadows, 0

    def stop(self) -> None:
        self.keep = False

    def _traced(self, cls, inner, *args, **kwargs):
        if self.keep and cls is not None:
            self.trace_rays.setdefault(cls, args[0].shape[0])
        if (self._keep_traces and self.keep and cls is not None
                and cls not in self.traces):
            self.traces[cls] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args) + (
                kwargs["presorted"],)
        self._cls = cls
        try:
            return inner(*args, **kwargs)
        finally:
            self._cls = None

    def _closest(self, inner, o, d, t_min, t_max, presorted=False):
        if presorted:
            cls = self._prefix + "gbuffer"
        elif self._bounces:
            cls = self._bounces[min(self._n_bounce, len(self._bounces) - 1)]
            self._n_bounce += 1
        else:
            cls = None
        return self._traced(cls, inner, o, d, t_min, t_max,
                            presorted=presorted)

    def _occluded(self, inner, o, d, t_min, t_max, presorted=False):
        shadow = presorted == "shadow"
        name = None
        if shadow and self._shadows:
            name = self._shadows[min(self._n_shadow, len(self._shadows) - 1)]
            self._n_shadow += 1
        elif shadow:
            name = self._prefix + "visibility"
        blocked = self._traced(name, inner, o, d, t_min, t_max,
                               presorted=presorted)
        if shadow:
            self.rays += blocked.numel()
            self.blocked += int(blocked.sum())
            if self.keep and self.oracle_rays is None:
                s = (blocked.numel() - ORACLE_RAYS) // 2 // 128 * 128
                self.oracle_rays = tuple(
                    x[s:s + ORACLE_RAYS].clone() for x in (o, d, t_min, t_max))
        return blocked

    def _walk(self, inner, *args, **kwargs):
        # the trace path passes the walk's six arguments positionally, and
        # its per-scene lanes by keyword
        if self.keep and self._cls is not None and self._cls not in self.walks:
            self.walks[self._cls] = (inner.__name__, tuple(
                a.clone() for a in args[:5]), args[5], dict(kwargs))
        return inner(*args, **kwargs)

    def _cull(self, inner, *args, **kwargs):
        # (rays8, amin, amax[, p]); the boxes are the clusters' own tensors
        key = (self._cls, inner.__name__)
        if self.keep and self._cls is not None and key not in self.culls:
            self.culls[key] = (args[0].clone(),) + tuple(args[1:])
        return inner(*args, **kwargs)

    def _pair_kernel(self, inner, *args, **kwargs):
        out = inner(*args, **kwargs)
        if not self.keep or self._cls is None:
            return out
        key = (self._cls, inner.__name__)
        if key not in self.pair_kernels:
            self.pair_kernels[key] = (tuple(
                a.clone() if torch.is_tensor(a) else a for a in args),
                dict(kwargs))
        tally = self.checked.setdefault(key, [0, 0, 0])
        if inner.__name__ == "pair_sweep":
            want = cp.pair_sweep_reference(*args)  # it reads wald_sc
            tally[1] += int((out != want).sum())
            tally[2] += int((want < cp.MISS_KEY).sum())
        else:
            want = binning.bin_scatter_reference(*args, **kwargs)
            tally[1] += sum(int((g != w).sum()) for g, w in zip(out, want)
                            if w is not None)
            tally[2] += int((want.slots >= 0).sum())
        tally[0] += 1
        return out

    def share(self) -> float:
        return self.blocked / max(self.rays, 1)


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


def phase_capture(scene, renderer, g_di, trace_log: TraceLog) -> None:
    """One DI frame that keeps its walks' inputs and the oracle's rays. It
    also warms the path up."""
    trace_log.start("di_", ("di_brdf_candidate",))
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    t0 = time.perf_counter()
    fr.render_frame(renderer, g_di.replace(frame=0, blend_factor=1.0), state)
    torch.cuda.synchronize()
    trace_log.stop()
    missing = ({"di_gbuffer", "di_brdf_candidate", "di_visibility"}
               - set(trace_log.walks))
    if missing or trace_log.oracle_rays is None:
        raise RuntimeError(f"the DI frame launched no walk for {missing}")
    log("capture", seconds=f"{time.perf_counter() - t0:.3f}",
        visibility_rays=trace_log.rays,
        blocked_share=f"{trace_log.share():.4f}",
        kept=json.dumps({k: v[1][0].shape[0]
                         for k, v in trace_log.walks.items()},
                        separators=(",", ":")))


def phase_kernel_di(renderer, trace_log: TraceLog) -> dict:
    """Each walk on the inputs the DI frame gave it, against its plain
    version: {kernel: {class: result}}."""
    real = lane_real(renderer.tracers)
    out = {"walk_closest": {}, "walk_occluded": {}}
    for cls, (kernel, args, group, kw) in sorted(trace_log.walks.items()):
        out[kernel][cls] = check_walk(kernel, cls, args, group, real, **kw)
    return out


def _blocked_with_slack(scene, wald, o, d, tn, tx, s_edge: int, s_min: int,
                        s_max: int) -> torch.Tensor:
    """Moller-Trumbore any-hit of a few rays against every triangle, with
    the triangle edges and the two segment ends each moved by the Wald
    test's float32 rounding bound for that ray and triangle, outwards (+1)
    or inwards (-1). wald: [T, 12] Wald coefficients per triangle."""
    _, t, u, v = moller_trumbore(
        o[:, None], d[:, None], scene.tri_v0[None], scene.tri_edge1[None],
        scene.tri_edge2[None], -torch.inf, torch.inf)
    ok = torch.isfinite(t) & (t != 0.0)
    # |terms| of o'_c = W_c . (o, 1) and d'_c = W_c . d, c in (u, v, z)
    aw, ao, ad = wald.abs()[None], o.abs()[:, None], d.abs()[:, None]
    so = [ao[..., 0] * aw[..., c] + ao[..., 1] * aw[..., c + 3]
          + ao[..., 2] * aw[..., c + 6] + aw[..., c + 9] for c in range(3)]
    sd = [ad[..., 0] * aw[..., c] + ad[..., 1] * aw[..., c + 3]
          + ad[..., 2] * aw[..., c + 6] for c in range(3)]
    dz = (d[:, None, 0] * wald[None, :, 2] + d[:, None, 1] * wald[None, :, 5]
          + d[:, None, 2] * wald[None, :, 8]).abs()
    # t = -o'_z / d'_z: the rounding of o'_z, and that of d'_z times |t|
    err_t = (WALD_ROUNDING * (so[2] + t.abs() * sd[2])
             / torch.clamp_min(dz, 1e-30))
    err_b = WALD_ROUNDING * (so[0] + so[1] + t.abs() * (sd[0] + sd[1]))
    inside = ((u >= -s_edge * err_b) & (v >= -s_edge * err_b)
              & (u + v <= 1.0 + s_edge * err_b))
    seg = (t > tn[:, None] - s_min * err_t) & (t < tx[:, None] + s_max * err_t)
    return (ok & inside & seg).any(dim=1)


def _rounding_ties(scene, tracers, rays, got) -> dict:
    """Of the visibility rays `rays` (o, d, t_min, t_max) on which a tracer
    answered `got` and a reference differs, the ties: the tracer's answer
    lies between the brute-force oracle's answers with every triangle edge
    and segment end moved inwards and with every one moved outwards by the
    float32 rounding bound of the walks' Wald test (large for a small
    triangle far from the origin): blocked only if some such move blocks
    it, clear only if some such move clears it. Returns the ties, which
    single bound moved outwards flips the oracle on them, and how many
    start outside the scene."""
    meta = tracers.tables.meta_rows
    real = meta[:, 12] >= 0
    wald = torch.empty((scene.num_triangles, 12), device=got.device)
    wald[meta[real, 12].long()] = meta[real, :12].contiguous().view(
        torch.float32)
    strict = _blocked_with_slack(scene, wald, *rays, -1, -1, -1)
    loose = _blocked_with_slack(scene, wald, *rays, 1, 1, 1)
    tied = torch.where(got, loose, ~strict)
    ties = {f"{name}_ties": int((tied & (_blocked_with_slack(
        scene, wald, *rays, *signs) != strict)).sum())
        for name, signs in (("t_max", (-1, -1, 1)), ("t_min", (-1, 1, -1)),
                            ("edge", (1, -1, -1)))}
    # rays from a sky pixel's surface at the background depth start
    # outside the scene; their segments end within float32 rounding of
    # the light sample, far below the segment's length
    o = rays[0]
    outside = ((o < tracers.scene_min) | (o > tracers.scene_max)).any(dim=-1)
    return {"tied": tied, **ties,
            "ties_from_outside_scene": int((tied & outside).sum())}


def phase_oracle_occlude(scene, renderer, batch,
                         phase: str = "oracle-occlude",
                         tie_tracers=None) -> None:
    """The tracers' any-hit query against the brute-force any-hit oracle;
    a ray on which they differ must be a rounding tie (_rounding_ties,
    through the walk tables of `tie_tracers`, by default the renderer's
    own)."""
    o, d, tn, tx = batch
    got = renderer.tracers.occluded(o, d, tn, tx, presorted="shadow")
    ref = occluded_brute_force(o, d, scene.tri_v0, scene.tri_edge1,
                               scene.tri_edge2, tn, tx)
    differ = torch.nonzero(got != ref).reshape(-1)
    r = tuple(x[differ] for x in (o, d, tn, tx))
    ties = _rounding_ties(scene, tie_tracers or renderer.tracers, r,
                          got[differ])
    tied = ties.pop("tied")
    bad = int((~tied).sum())
    live = int((tx > tn).sum())
    log(phase, cls="shadow", rays=ORACLE_RAYS, live_rays=live,
        blocked=int(ref.sum()), same=ORACLE_RAYS - differ.numel(),
        ties=int(tied.sum()), **ties, disagree=bad)
    if bad:
        raise RuntimeError(f"{bad} visibility rays disagree with the "
                           "brute-force oracle beyond ties")


def _reset_counts(tracers) -> None:
    for name in KERNELS:
        getattr(KERNEL_MODULES[name], name).launches = 0
    tracers.fallback_by_class.clear()


def _launches() -> dict:
    return {name: launch_count(name) for name in KERNELS}


def phase_di_frames(scene, renderer, g_di, trace_log: TraceLog):
    """Two DI frames from a fresh state (blend_factor 1/(f+1), as
    bench.py's DI loop); every count is reset just before them. Returns
    the launches and the displays."""
    tracers = renderer.tracers
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    _reset_counts(tracers)
    imgs = []
    for f in range(2):
        trace_log.rays = trace_log.blocked = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, img = fr.render_frame(
            renderer, g_di.replace(frame=f, blend_factor=1.0 / (f + 1)),
            state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log("di-frame", frame=f, seconds=f"{sec:.3f}",
            launches=json.dumps(_launches(), separators=(",", ":")),
            fallback_bundles=json.dumps(
                {str(k): v for k, v in tracers.fallback_by_class.items()},
                separators=(",", ":")),
            visibility_rays=trace_log.rays,
            blocked_share=f"{trace_log.share():.4f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        _check_image("di display", img, display=True)
        imgs.append(img)
    _check_image("di diffuse_lighting", state.diffuse_lighting, display=False)
    _check_image("di specular_lighting", state.specular_lighting,
                 display=False)
    launches = _launches()
    for name in WALKS:
        if launches[name] <= 0:
            raise RuntimeError(f"the DI frames never launched {name}")
    return launches, imgs


def _timed(spent: dict, key):
    """A _Patch hook that synchronises the card around each call and adds
    its wall time to spent[key(kwargs)]."""
    def hook(inner, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        k = key(kwargs)
        spent[k] = spent.get(k, 0.0) + time.perf_counter() - t0
        return out
    return hook


def _busy_ms(events) -> float:
    """Length of the union of the card's kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_di_breakdown(scene, renderer, g_di) -> None:
    """Where a DI frame's time goes, from two more frames after the
    counted ones: one with every trace call and walk launch synchronised
    and timed (so a little slower than the frames above), and one under
    torch.profiler for the card's busy and idle shares."""
    tracers = renderer.tracers
    g = g_di.replace(frame=2, blend_factor=1.0 / 3)
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    spent = {}
    wraps = [
        _Patch(tracers, "closest_hit", _timed(
            spent, lambda kw: "gbuffer_trace" if kw.get("presorted")
            else "brdf_candidate_trace")),
        _Patch(tracers, "occluded", _timed(
            spent, lambda kw: "visibility_trace")),
        _Patch(ct, "walk_closest", _timed(spent, lambda kw: "walk_closest")),
        _Patch(ct, "walk_occluded", _timed(
            spent, lambda kw: "walk_occluded")),
    ]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.render_frame(renderer, g, state)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
    finally:
        for w in reversed(wraps):
            w.restore()
    traces = sum(v for k, v in spent.items() if k.endswith("_trace"))
    log("di-breakdown", frame_ms=f"{frame_s * 1e3:.1f}",
        **{f"{k}_ms": f"{v * 1e3:.1f}" for k, v in sorted(spent.items())},
        other_ms=f"{(frame_s - traces) * 1e3:.1f}")

    _profile_frame("di-profile", renderer, g, state)


def _profile_frame(phase: str, renderer, g, state) -> None:
    """One frame under torch.profiler: wall time, the card's busy time (the
    union of its kernel intervals) and its idle share."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.render_frame(renderer, g, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = _busy_ms(events)
    kernels = sum(1 for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    log(phase, wall_ms=f"{wall_ms:.1f}", busy_ms=f"{busy:.1f}",
        idle_share=f"{1.0 - busy / wall_ms:.4f}", kernels=kernels)


def phase_flagship_capture(scene, renderer, g_flag,
                           trace_log: TraceLog) -> None:
    """One flagship DI+GI frame that keeps the inputs of each cull launch
    of its bounce-class traces and of the first walk launch of its
    G-buffer and bounce traces (it also warms the path up)."""
    trace_log.start("flagship_", tuple(f"flagship_{b}"
                                       for b in FLAGSHIP_BOUNCES))
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    t0 = time.perf_counter()
    fr.render_frame(renderer, g_flag.replace(frame=0), state)
    torch.cuda.synchronize()
    trace_log.stop()
    want = {(f"flagship_{b}", k) for b in FLAGSHIP_BOUNCES for k in CULLS}
    missing = (want - set(trace_log.culls)) | (
        set(FLAGSHIP_WALKS) - set(trace_log.walks))
    if missing:
        raise RuntimeError(f"the flagship frame launched no cull or walk "
                           f"for {sorted(missing, key=str)}")
    log("flagship-capture", seconds=f"{time.perf_counter() - t0:.3f}",
        kept=json.dumps({f"{c}:{k}": v[0].shape[0]
                         for (c, k), v in sorted(trace_log.culls.items())
                         if c is not None}, separators=(",", ":")),
        kept_walks=json.dumps({c: v[1][0].shape[0]
                               for c, v in sorted(trace_log.walks.items())},
                              separators=(",", ":")))


def phase_kernel_flagship(renderer, trace_log: TraceLog) -> dict:
    """walk_closest against its plain version on the flagship frame's own
    batches (its G-buffer and its three bounce traces): {class: result}."""
    real = lane_real(renderer.tracers)
    out = {}
    for cls in FLAGSHIP_WALKS:
        kernel, args, group, kw = trace_log.walks[cls]
        out[cls] = check_walk(kernel, cls, args, group, real, **kw)
    return out


def phase_kernel_cull(trace_log: TraceLog) -> dict:
    """Both cull kernels against their plain versions on the flagship
    frame's three bounce batches, and bundle_union on the DI frame's
    visibility batch: {kernel: {class: result}}."""
    out = {k: {} for k in CULLS}
    checks = [(f"flagship_{b}", k) for b in FLAGSHIP_BOUNCES for k in CULLS]
    checks.append(("di_visibility", "bundle_union"))
    for cls, kernel in checks:
        out[kernel][cls] = check_cull(kernel, cls, trace_log.culls[cls,
                                                                   kernel])
    return out


def phase_flagship_frames(scene, renderer, g_flag):
    """FLAGSHIP_FRAMES flagship frames from a fresh state; every count is
    reset just before them. The frame casts no visibility ray, so the
    any-hit walk does not launch; the other three kernels must. Returns
    the launches, the displays and each frame's seconds."""
    tracers = renderer.tracers
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    _reset_counts(tracers)
    imgs, seconds = [], []
    for f in range(FLAGSHIP_FRAMES):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, img = fr.render_frame(renderer, g_flag.replace(frame=f),
                                     state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        seconds.append(sec)
        log("flagship-frame", frame=f, seconds=f"{sec:.3f}",
            launches=json.dumps(_launches(), separators=(",", ":")),
            fallback_bundles=json.dumps(
                {str(k): v for k, v in tracers.fallback_by_class.items()},
                separators=(",", ":")),
            gi_valid_share=f"{float((state.gi_reservoirs[0].m > 0).float().mean()):.4f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        _check_image("flagship display", img, display=True)
        imgs.append(img)
    _check_image("flagship diffuse_lighting", state.diffuse_lighting,
                 display=False)
    _check_image("flagship specular_lighting", state.specular_lighting,
                 display=False)
    launches = _launches()
    for name in ("walk_closest", "nearest_box", "bundle_union"):
        if launches[name] <= 0:
            raise RuntimeError(f"the flagship frames never launched {name}")
    return launches, imgs, seconds


def phase_flagship_breakdown(scene, renderer, g_flag) -> None:
    """Where a flagship frame's time goes: one more frame with every trace
    call and, inside it, B3, the cand0 sort (key tail, argsort and
    permutation; cand0_sort_ms includes B3), B4, the ranking, the walk and
    the decode synchronised and timed (so a little slower than the frames
    above), and one under torch.profiler for the card's idle share."""
    _breakdown("flagship", scene, renderer, g_flag.replace(
        frame=FLAGSHIP_FRAMES), [
        (cull, "nearest_box", "b3_nearest_box"),
        (ct, "_cand0_sort", "cand0_sort"),
        (cull, "bundle_union", "b4_bundle_union"),
        (ct, "_rank", "rank"),
        (ct, "walk_closest", "walk"),
        (ct, "walk_occluded", "walk"),
        (ct, "_decode", "decode")], nested=("b3_nearest_box",))


def _breakdown(phase: str, scene, renderer, g, parts, nested) -> None:
    """One frame with every trace call and each (owner, attr, name) part
    inside it synchronised and timed, logged per trace as phase + "-trace"
    (other_ms: the trace's time outside the parts, the `nested` parts
    being inside others) and in all as phase + "-breakdown"; then one
    frame under torch.profiler (phase + "-profile")."""
    tracers = renderer.tracers
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    spent = {}
    trace = {"name": None, "bounce": 0}

    def closest_name(kw):
        if kw.get("presorted"):
            return "gbuffer"
        i = min(trace["bounce"], len(FLAGSHIP_BOUNCES) - 1)
        trace["bounce"] += 1
        return FLAGSHIP_BOUNCES[i]

    def trace_hook(name_of):
        def hook(inner, *args, **kwargs):
            trace["name"] = name_of(kwargs)
            try:
                return _timed(spent, lambda kw: (trace["name"], "trace"))(
                    inner, *args, **kwargs)
            finally:
                trace["name"] = None
        return hook

    def part(name):
        return _timed(spent, lambda kw: (trace["name"] or "outside", name))

    wraps = [
        _Patch(tracers, "closest_hit", trace_hook(closest_name)),
        _Patch(tracers, "occluded", trace_hook(lambda kw: "visibility")),
    ] + [_Patch(owner, attr, part(name)) for owner, attr, name in parts]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.render_frame(renderer, g, state)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
    finally:
        for w in reversed(wraps):
            w.restore()
    names = sorted({k[0] for k in spent if k[1] == "trace"})
    traces = 0.0
    for name in names:
        times = {k[1]: v for k, v in spent.items() if k[0] == name}
        total = times.pop("trace")
        traces += total
        inner = sum(v for k, v in times.items() if k not in nested)
        log(f"{phase}-trace", trace=name, trace_ms=f"{total * 1e3:.2f}",
            **{f"{k}_ms": f"{v * 1e3:.2f}" for k, v in sorted(times.items())},
            other_ms=f"{(total - inner) * 1e3:.2f}")
    log(f"{phase}-breakdown", frame_ms=f"{frame_s * 1e3:.1f}",
        traces_ms=f"{traces * 1e3:.1f}",
        outside_traces_ms=f"{(frame_s - traces) * 1e3:.1f}")
    _profile_frame(f"{phase}-profile", renderer, g, state)


def phase_gi_resampling(scene, renderer, view) -> None:
    """Two full-size frames of the goldens' configuration (GI temporal and
    spatial resampling on): the second resamples the first's reservoirs."""
    g = flagship_gconst(renderer, view, enable_temporal_resampling=1,
                        enable_spatial_resampling=1)
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    for f in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, img = fr.render_frame(renderer, g.replace(frame=f), state)
        torch.cuda.synchronize()
        valid = [float((r.m > 0).float().mean()) for r in state.gi_reservoirs]
        finite = all(bool(torch.isfinite(x).all())
                     for r in state.gi_reservoirs for x in r)
        log("gi-resampling", frame=f,
            seconds=f"{time.perf_counter() - t0:.3f}",
            gi_valid_share=json.dumps([round(v, 4) for v in valid]),
            reservoirs_finite=finite)
        _check_image("gi-resampling display", img, display=True)
        if not finite:
            raise RuntimeError("the GI reservoirs are not finite")


# ---------------------------------------------------------------------------
# DI resampling, ReGIR and the k_cand probe
# ---------------------------------------------------------------------------

def _view_at(f: int):
    """The smoke camera moved RESAMPLING_STEP along x per frame (a few
    pixels of screen motion on the corridor), so the reprojection moves."""
    cam = default_camera(window_size=(WIDTH, HEIGHT),
                         position=(RESAMPLING_STEP * f, 4, 90),
                         direction=(0, 0, 1))
    return cam.planar_view_constants()


def resampling_gconst(scene, f: int, mode: int = 3, bias: int = 3):
    """The DI validation config (di_gconst) at frame f of the moving
    camera with DI resampling mode `mode` (3: temporal and spatial),
    temporal and spatial bias correction `bias` (3: ray-traced) and the
    boiling filter on."""
    g = di_gconst(scene, _view_at(f))
    di = g.restir_di
    return g.replace(
        frame=f, blend_factor=1.0 / (f + 1), prev_view=_view_at(max(f - 1, 0)),
        enable_di_resampling=mode, restir_di=dataclasses.replace(
            di,
            temporal_resampling_params=dataclasses.replace(
                di.temporal_resampling_params, temporal_bias_correction=bias,
                enable_boiling_filter=1, boiling_filter_strength=0.2),
            spatial_resampling_params=dataclasses.replace(
                di.spatial_resampling_params,
                spatial_bias_correction=bias)))


def phase_di_resampling(scene, renderer) -> tuple[dict, dict]:
    """RESAMPLING_FRAMES DI frames with temporal and spatial resampling,
    ray-traced bias correction and the boiling filter, the camera moving;
    every count is reset just before them and B1-B4 must have launched.
    The frame after them keeps the inputs of B2 and B4 on its temporal and
    first spatial visibility batch, held to their plain versions bit for
    bit (di-resampling-kernel). Then one frame each of modes 1 and 2 and
    of bias modes 0-2 from the last state, each finite. Returns (the
    launches, {kernel: {class: result}})."""
    tracers = renderer.tracers
    srp = resampling_gconst(scene, 0).restir_di.spatial_resampling_params
    n_spatial = max(srp.num_spatial_samples,
                    srp.num_disocclusion_boost_samples)
    shadows = (("rs_temporal_visibility",)
               + tuple(f"rs_spatial_visibility_{i}" for i in range(n_spatial))
               + ("rs_visibility",))
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    _reset_counts(tracers)
    seconds, b2 = [], []
    for f in range(RESAMPLING_FRAMES):
        before = launch_count("walk_occluded")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, img = fr.render_frame(renderer, resampling_gconst(scene, f),
                                     state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        b2.append(launch_count("walk_occluded") - before)
        _check_image("di-resampling display", img, display=True)
    launches = _launches()
    m = state.di_reservoirs[1].m
    log("di-resampling", frames=RESAMPLING_FRAMES,
        seconds=json.dumps([round(x, 3) for x in seconds]),
        median_s=f"{statistics.median(seconds):.3f}",
        b2_launches_per_frame=json.dumps(b2),
        launches=json.dumps(launches, separators=(",", ":")),
        fallback_bundles=json.dumps(
            {str(k): v for k, v in tracers.fallback_by_class.items()},
            separators=(",", ":")),
        history_m_mean=f"{float(m.mean()):.3f}", history_m_max=float(m.max()),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    _check_image("di-resampling diffuse_lighting", state.diffuse_lighting,
                 display=False)
    for kernel in WALKS + CULLS:
        if launches[kernel] <= 0:
            raise RuntimeError(f"the resampling frames never launched "
                               f"{kernel}")
    if b2[-1] != len(shadows):
        raise RuntimeError(f"a resampling frame cast {b2[-1]} visibility "
                           f"batches, not {len(shadows)}")

    trace_log = TraceLog(tracers)
    try:
        trace_log.start("rs_", ("rs_brdf_candidate",), shadows)
        f = RESAMPLING_FRAMES
        state, _ = fr.render_frame(renderer, resampling_gconst(scene, f),
                                   state)
        torch.cuda.synchronize()
        trace_log.stop()
    finally:
        trace_log.restore()
    real = lane_real(tracers)
    out = {"walk_occluded": {}, "bundle_union": {}}
    for cls in shadows[:2]:
        kernel, args, group, kw = trace_log.walks[cls]
        out[kernel][cls] = check_walk(kernel, cls, args, group, real,
                                      **kw)
        out["bundle_union"][cls] = check_cull(
            "bundle_union", cls, trace_log.culls[cls, "bundle_union"])
    del trace_log

    for mode, bias in ((1, 3), (2, 3), (3, 0), (3, 1), (3, 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s2, img = fr.render_frame(
            renderer, resampling_gconst(scene, f + 1, mode, bias), state)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(x).all())
                     for x in s2.di_reservoirs[0] if x.is_floating_point())
        log("di-resampling-variant", mode=mode, bias=bias,
            seconds=f"{time.perf_counter() - t0:.3f}",
            reservoirs_finite=finite)
        _check_image(f"di-resampling mode {mode} bias {bias} display", img,
                     display=True)
        if not finite:
            raise RuntimeError(f"mode {mode} bias {bias}: the DI reservoirs "
                               "are not finite")
    return launches, out


def phase_regir(scene, view) -> dict:
    """create_renderer(regir=True) on the ladder: the ReGIR grid (16^3
    cells of 128 lights) built on the card, timed alone once more, and
    the share of its slots that hold a light; then REGIR_FRAMES DI frames
    with local-light sampling mode 2, every count reset just before them:
    lit and finite, and B1, B2 and B4 must have launched. Returns the
    launches."""
    t0 = time.perf_counter()
    renderer = fr.create_renderer(scene, WIDTH, HEIGHT, regir=True)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    p = renderer.regir_params
    lights = renderer.scene_lights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = presample_regir_grid(0, lights.lights, LightBufferRegion(
        0, lights.num_local_lights), p)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    if not torch.equal(buf, renderer.regir_ris_buffer):
        raise RuntimeError("the ReGIR grid differs between two builds")
    filled = float((buf[:, 1] != 0).float().mean())
    log("regir", cells=json.dumps(list(p.cells)),
        lights_per_cell=p.lights_per_cell, slots=buf.shape[0],
        cell_size=f"{p.cell_size:.4f}", create_renderer_s=f"{create_s:.3f}",
        grid_s=f"{grid_s:.4f}", filled_share=f"{filled:.6f}")
    if filled <= 0.0:
        raise RuntimeError("the ReGIR grid holds no light")

    g = di_gconst(scene, view)
    di = g.restir_di
    g = g.replace(restir_di=dataclasses.replace(
        di, initial_sampling_params=dataclasses.replace(
            di.initial_sampling_params, local_light_sampling_mode=2)))
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    _reset_counts(renderer.tracers)
    seconds = []
    for f in range(REGIR_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, img = fr.render_frame(
            renderer, g.replace(frame=f, blend_factor=1.0 / (f + 1)), state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        _check_image("regir display", img, display=True)
    launches = _launches()
    log("regir-frames", seconds=json.dumps([round(x, 3) for x in seconds]),
        launches=json.dumps(launches, separators=(",", ":")))
    for kernel in ("walk_closest", "walk_occluded", "bundle_union"):
        if launches[kernel] <= 0:
            raise RuntimeError(f"the ReGIR frames never launched {kernel}")
    return launches


def _plain_cull(inner, *args, **kwargs):
    """A _Patch hook that runs a cull kernel's plain version instead."""
    return getattr(cull, f"{inner.__name__}_reference")(*args, **kwargs)


def phase_k_cand(scene, renderer, view, g_flag, flag_img) -> tuple[dict,
                                                                   dict]:
    """suggest_k_cand(renderer, view) on the ladder, every count reset just
    before it: its two probe maxima, the budgets it suggests and its
    seconds; B3 and B4 must have launched, and union_max_bundle through
    the plain cull versions must give each maximum again. Then tracers
    with those budgets render flagship frame 0: the pixels that differ
    from the default frame 0, whose hits must differ by key ties only
    (each kept trace through both tracers, as pairs-ties). Returns the
    launches of the probe and of the frame."""
    tracers = renderer.tracers
    probes = []

    def record(inner, *args, **kwargs):
        out = inner(*args, **kwargs)
        probes.append((args, kwargs, out))
        return out

    patch = _Patch(tracers, "union_max", record)
    _reset_counts(tracers)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suggestion = app_bridge.suggest_k_cand(renderer, view)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        patch.restore()
    probe_launches = _launches()
    maxima = [int(out) for _, _, out in probes]
    plain = []
    patches = [_Patch(cull, name, _plain_cull) for name in CULLS]
    try:
        for args, kwargs, _ in probes:
            plain.append(int(tracers.union_max(*args, **kwargs)))
    finally:
        for w in reversed(patches):
            w.restore()
    log("k-cand", probe_rays=json.dumps([a[0].shape[0] for a, _, _ in probes]),
        maxima=json.dumps(maxima), plain_maxima=json.dumps(plain),
        suggested=json.dumps({str(k): v for k, v in (suggestion or {}).items()}),
        current=json.dumps({str(k): v for k, v in
                            tracers.k_cand_by_class.items()}),
        seconds=f"{seconds:.3f}",
        launches=json.dumps(probe_launches, separators=(",", ":")))
    if len(maxima) != 2 or plain != maxima:
        raise RuntimeError(f"the probe's maxima {maxima} through the "
                           f"kernels differ from {plain} through the plain "
                           "versions")
    for kernel in CULLS:
        if probe_launches[kernel] <= 0:
            raise RuntimeError(f"the probe never launched {kernel}")
    if suggestion is None:
        raise RuntimeError("suggest_k_cand made no suggestion")

    k_renderer = dataclasses.replace(renderer, tracers=app_bridge.make_tracers(
        scene, k_cand_per_class=suggestion))
    trace_log = TraceLog(k_renderer.tracers, keep_traces=True)
    _reset_counts(k_renderer.tracers)
    try:
        trace_log.start("kc_", tuple(f"kc_{b}" for b in FLAGSHIP_BOUNCES))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, img = fr.render_frame(
            k_renderer, g_flag.replace(frame=0),
            fr.init_frame_state(WIDTH, HEIGHT, device=scene.device))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        trace_log.stop()
    finally:
        trace_log.restore()
    frame_launches = _launches()
    _check_image("k-cand flagship display", img, display=True)
    log("k-cand-frame", seconds=f"{sec:.3f}",
        k_cand_by_class=json.dumps({str(k): v for k, v in
                                    k_renderer.tracers.k_cand_by_class
                                    .items()}),
        fallback_by_class=json.dumps(
            {str(k): v for k, v in
             k_renderer.tracers.fallback_by_class.items()},
            separators=(",", ":")),
        launches=json.dumps(frame_launches, separators=(",", ":")),
        **_pixels_differing(img, flag_img, against="default"))
    for name, trace in sorted(trace_log.traces.items()):
        o, d, tn, tx, presorted = trace
        got = k_renderer.tracers.closest_hit(o, d, tn, tx,
                                             presorted=presorted)
        ref = tracers.closest_hit(o, d, tn, tx, presorted=presorted)
        log("k-cand-ties", trace=name, rays=o.shape[0],
            **_backends_agree("k-cand-ties", scene, renderer, name,
                              _per_ray(trace), got, ref))
    return probe_launches, frame_launches


# ---------------------------------------------------------------------------
# The lbvh backend, the app and the viewer
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def phase_lbvh_build(scene):
    """build_lbvh on the card, timed: its depth (at most LBVH_MAX_DEPTH),
    validate_bvh, and its five arrays bit-equal to the port's build of the
    same host triangles on the CPU. Then create_renderer(backend="lbvh"),
    whose BVH must be the same. Returns that renderer."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bvh = build_lbvh(scene.tri_v0, scene.tri_edge1, scene.tri_edge2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    depth = max_depth(bvh)
    valid = validate_bvh(bvh)
    t0 = time.perf_counter()
    host = build_lbvh(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        scene.host_tri_v0, scene.host_tri_edge1, scene.host_tri_edge2)))
    cpu_seconds = time.perf_counter() - t0
    differ = {f: int((_bits(getattr(bvh, f)).cpu()
                      != _bits(getattr(host, f))).sum()) for f in LBVH_FIELDS}
    t0 = time.perf_counter()
    renderer_l = fr.create_renderer(scene, WIDTH, HEIGHT, backend="lbvh")
    torch.cuda.synchronize()
    renderer_seconds = time.perf_counter() - t0
    same = all(torch.equal(_bits(getattr(renderer_l.tracers.bvh, f)),
                           _bits(getattr(bvh, f))) for f in LBVH_FIELDS)
    log("lbvh-build", leaves=bvh.num_leaves, seconds=f"{seconds:.4f}",
        cpu_seconds=f"{cpu_seconds:.3f}", max_depth=depth,
        validate_max_stack=valid["max_depth"],
        differ_from_cpu=json.dumps(differ, separators=(",", ":")),
        create_renderer_seconds=f"{renderer_seconds:.3f}",
        renderer_bvh_same=same)
    if depth > LBVH_MAX_DEPTH:
        raise RuntimeError(f"the LBVH is {depth} deep, JAX's build "
                           f"{LBVH_MAX_DEPTH}")
    if any(differ.values()) or not same:
        raise RuntimeError(f"the card's LBVH differs from the CPU build "
                           f"({differ}) or from create_renderer's ({same})")
    return renderer_l


def _lbvh_agrees(scene, name, rays, got, ref) -> dict:
    """lbvh's closest hits `got` for a batch against the bundle walk's
    `ref`: a hit that differs is a key tie (as _backends_agree), or else
    the brute-force oracle, which shares the lbvh walk's Möller-Trumbore
    arithmetic, decides: lbvh must equal it up to a t-tie (the bundle
    walk's Wald test rounds those rays differently). Returns the counts to
    log; raises on any other difference."""
    o, d, tn, tx = rays
    differ = got.triangle_index != ref.triangle_index
    rel = (got.t - ref.t).abs() / ref.t.abs()
    tie = differ & (got.missed == ref.missed) & (rel <= KEY_TIE_REL)
    rest = torch.nonzero(differ & ~tie).reshape(-1)
    fields = dict(hits=int((~got.missed).sum()), differ=int(differ.sum()),
                  key_ties=int(tie.sum()), oracle_decides=rest.numel())
    if rest.numel() == 0:
        return dict(fields, lbvh_is_oracle=0, disagree=0)
    if rest.numel() > ORACLE_RAYS:
        raise RuntimeError(f"oracle-lbvh {name}: {rest.numel()} hits differ "
                           "from the bundle walk beyond key ties")
    oracle = intersect_brute_force(
        o[rest], d[rest], scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
        scene.tri_geometry, scene.tri_primitive, tn[rest], tx[rest])
    g = type(got)(*(f[rest] for f in got))
    ok = (g.triangle_index == oracle.triangle_index) | (
        (g.missed == oracle.missed)
        & ((g.t - oracle.t).abs() <= TIE_REL * oracle.t.abs()))
    bad = torch.nonzero(~ok).reshape(-1)
    fields.update(lbvh_is_oracle=int(ok.sum()), disagree=bad.numel(),
                  first_disagreeing=json.dumps([
                      [int(rest[i]), float(g.t[i]), float(oracle.t[i]),
                       int(g.triangle_index[i]),
                       int(oracle.triangle_index[i])]
                      for i in bad[:4].tolist()]))
    if bad.numel():
        log("oracle-lbvh", cls=name, **fields)
        raise RuntimeError(f"oracle-lbvh {name}: {bad.numel()} lbvh hits "
                           "differ from the brute-force oracle")
    return fields


def _walk_delta(stats, before) -> dict:
    """The lbvh walk's calls, steps and host checks since `before`."""
    calls = stats.calls - before.calls
    steps = stats.steps - before.steps
    return {"calls": calls, "steps": steps,
            "host_checks": stats.host_checks - before.host_checks,
            "steps_per_call": f"{steps / max(calls, 1):.1f}"}


def phase_oracle_lbvh(scene, renderer, renderer_l, batches,
                      oracle_rays) -> None:
    """lbvh's closest hit against the brute-force tracer on ORACLE_RAYS
    rays of each main_path_batches class and its any hit against the
    any-hit oracle on the kept visibility rays (phase_oracle,
    phase_oracle_occlude); then each whole 262,144-ray batch through lbvh
    against the bundle walk (_lbvh_agrees), timed, with the walk's steps
    and host checks."""
    stats = renderer_l.tracers.walk_stats
    start = dataclasses.replace(stats)
    phase_oracle(scene, renderer_l, batches, phase="oracle-lbvh")
    # the lbvh walk has no Wald tables: ties take the bundle walk's bound,
    # which is wider than the Möller-Trumbore rounding the two share
    phase_oracle_occlude(scene, renderer_l, oracle_rays, phase="oracle-lbvh",
                         tie_tracers=renderer.tracers)
    for cls, (presorted, o, d, tn, tx) in batches.items():
        before = dataclasses.replace(stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = renderer_l.tracers.closest_hit(o, d, tn, tx,
                                             presorted=presorted)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = renderer.tracers.closest_hit(o, d, tn, tx, presorted=presorted)
        log("oracle-lbvh", cls=cls, rays=o.shape[0], ms=f"{ms:.2f}",
            **_walk_delta(stats, before),
            **_lbvh_agrees(scene, cls, (o, d, tn, tx), got, ref))
    log("oracle-lbvh", total=json.dumps(_walk_delta(stats, start)))


def phase_lbvh_frames(scene, renderer_l, g_flag, g_di, flag_imgs,
                      di_imgs) -> dict:
    """LBVH_FLAGSHIP_FRAMES flagship frames (from a fresh state, as the
    bundle frames they are compared with) and one DI frame (fresh)
    through create_renderer(backend="lbvh"), each timed, with every trace
    call timed between synchronisations and the walk's steps per trace;
    every count is reset just before them and no kernel may launch (the
    lbvh walk is torch ops). Each display is compared with the bundle
    backend's frame of the same index."""
    tracers = renderer_l.tracers
    stats = tracers.walk_stats
    trace_ms = []

    def timed(inner, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        trace_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    patches = [_Patch(tracers, "closest_hit", timed),
               _Patch(tracers, "occluded", timed)]
    _reset_counts(tracers)
    runs = [("flagship", g_flag.replace(frame=f), flag_imgs[f])
            for f in range(LBVH_FLAGSHIP_FRAMES)]
    runs.append(("di", g_di.replace(frame=0, blend_factor=1.0), di_imgs[0]))
    state = None
    try:
        for config, g, ref in runs:
            if state is None or config == "di":
                state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
            trace_ms.clear()
            before = dataclasses.replace(stats)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, img = fr.render_frame(renderer_l, g, state)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            walk = _walk_delta(stats, before)
            log("lbvh-frame", config=config, frame=int(g.frame),
                seconds=f"{sec:.3f}", traces=len(trace_ms),
                trace_ms=json.dumps([round(t, 2) for t in trace_ms]),
                traces_ms=f"{sum(trace_ms):.2f}", **walk,
                launches=json.dumps(_launches(), separators=(",", ":")),
                **_pixels_differing(img, ref),
                peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
            _check_image(f"lbvh {config} display", img, display=True)
    finally:
        for patch in reversed(patches):
            patch.restore()
    launches = _launches()
    if any(launches.values()):
        raise RuntimeError(f"the lbvh frames launched kernels: {launches}")
    return launches


class _Records(logging.Handler):
    """Keeps the message of every record it is given."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def phase_app(dev: torch.device, flag_seconds) -> dict:
    """app.main on `dev` with the ladder GLB at WIDTH x HEIGHT for
    APP_FRAMES frames (the camera of the other phases; an --animate file
    turning GI off at frame 2; --checkpoint), then --resume from that
    checkpoint for APP_RESUME_FRAMES frames. Every PNG must decode (utils/png.read_png)
    to a lit WIDTH x HEIGHT image, metrics.json must hold the JAX app's
    keys with a traversal_overflow, the k_cand probe's budgets must be
    logged, and B1, B3 and B4 must have launched inside the app's frames
    (counted around each render_frame call). Returns those launches."""
    in_frames = {name: 0 for name in KERNELS}
    per_frame = []

    def count(inner, *args, **kwargs):
        before = _launches()
        out = inner(*args, **kwargs)
        delta = {k: v - before[k] for k, v in _launches().items()}
        per_frame.append(delta)
        for k, v in delta.items():
            in_frames[k] += v
        return out

    records = _Records()
    app_log = logging.getLogger("raytracer2_tpu_torch")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        glb = d / "ladder.glb"
        proc.write_glb(glb, proc.corridor_glb(**LADDER))
        (d / "animate.json").write_text(
            json.dumps({"2": {"enable_restir_gi": 0}}))
        common = [str(glb), "--device", str(dev), "--width", str(WIDTH),
                  "--height", str(HEIGHT),
                  "--camera-pos", *map(str, CAMERA_POS),
                  "--camera-dir", *map(str, CAMERA_DIR)]
        runs = {"run": (APP_FRAMES, 0, ["--animate", str(d / "animate.json"),
                                        "--checkpoint", str(d / "s.npz")]),
                "resume": (APP_RESUME_FRAMES, APP_FRAMES,
                           ["--resume", str(d / "s.npz")])}
        patch = _Patch(fr, "render_frame", count)
        app_log.addHandler(records)
        metrics = {}
        try:
            for name, (frames, first, extra) in runs.items():
                t0 = time.perf_counter()
                rc = app.main(common + ["--frames", str(frames),
                                        "--out", str(d / name)] + extra)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                if rc != 0:
                    raise RuntimeError(f"app {name}: exit code {rc}")
                metrics[name] = json.loads(
                    (d / name / "metrics.json").read_text())
                lit = []
                for f in range(first, first + frames):
                    png = read_png(d / name / f"frame_{f:04d}.png")
                    if png.shape != (HEIGHT, WIDTH, 3) or png.max() == 0:
                        raise RuntimeError(f"app {name}: frame {f} is "
                                           f"{png.shape}, max {png.max()}")
                    lit.append(round(float(png.mean()), 2))
                m = metrics[name]
                log("app", run=name, seconds=f"{sec:.1f}",
                    frames=m["frames"], p50_ms=m["p50_ms"],
                    mean_ms=m["mean_ms"],
                    traversal_overflow=m["traversal_overflow"],
                    png_means=json.dumps(lit))
        finally:
            app_log.removeHandler(records)
            patch.restore()
    suggested = [m for m in records.messages
                 if m.startswith("zero-truncation k_cand per class")]
    flag_ms = statistics.median(flag_seconds) * 1e3
    log("app", flagship_frame_ms=f"{flag_ms:.1f}",
        p50_ms=metrics["run"]["p50_ms"],
        resume_p50_ms=metrics["resume"]["p50_ms"],
        suggested=repr(suggested[0][:80] if suggested else None),
        launches=json.dumps(in_frames, separators=(",", ":")),
        launches_per_frame=json.dumps(
            [[v[k] for k in ("walk_closest", "nearest_box", "bundle_union")]
             for v in per_frame], separators=(",", ":")))
    for name, m in metrics.items():
        if set(m) != APP_METRICS or m["traversal_overflow"] is None:
            raise RuntimeError(f"app {name}: metrics.json {sorted(m)} with "
                               f"traversal_overflow "
                               f"{m['traversal_overflow']}")
    if not suggested:
        raise RuntimeError("the app logged no suggested k_cand budgets")
    for kernel in ("walk_closest", "nearest_box", "bundle_union"):
        if in_frames[kernel] <= 0:
            raise RuntimeError(f"the app's frames never launched {kernel}")
    return in_frames


def phase_viewer(scene, renderer) -> None:
    """viewer.run_interactive for VIEWER_FRAMES flagship frames at
    VIEWER_SIZE through the bundle backend, on a pseudo-terminal: the keys
    "w" and "1" are written into it before each frame, and the output
    goes to a string. It must hold every half-block frame, and the camera
    must have moved."""
    w, h = VIEWER_SIZE
    renderer_v = dataclasses.replace(renderer, width=w, height=h)
    cam = default_camera(window_size=(w, h), position=CAMERA_POS,
                         direction=CAMERA_DIR)
    g = flagship_gconst(renderer_v, cam.planar_view_constants())
    positions = []
    master, slave = os.openpty()
    stdin = os.fdopen(slave, "r")

    def render(g, state):
        os.write(master, b"w1")
        positions.append(g.view.camera_direction_or_position[:3].tolist())
        return fr.render_frame(renderer_v, g, state)

    out = io.StringIO()
    saved, sys.stdin = sys.stdin, stdin
    t0 = time.perf_counter()
    try:
        viewer.run_interactive(
            render, cam, g, fr.init_frame_state(w, h, device=scene.device),
            lambda img: to_srgb_u8(img).cpu().numpy(),
            max_frames=VIEWER_FRAMES, out=out)
    finally:
        sys.stdin = saved
        stdin.close()
        os.close(master)
    sec = time.perf_counter() - t0
    text = out.getvalue()
    frames, cells = text.count("\x1b[H"), text.count("▀")
    log("viewer", frames=frames, cells=cells, chars=len(text),
        seconds=f"{sec:.3f}", positions=json.dumps(positions))
    if frames != VIEWER_FRAMES or cells == 0 or positions[-1] == positions[0]:
        raise RuntimeError(f"viewer: {frames} frames, {cells} cells, camera "
                           f"{positions[0]} -> {positions[-1]}")


# ---------------------------------------------------------------------------
# The skybox, checkerboard fields and the per-pass split
# ---------------------------------------------------------------------------

def exr_round_trip(height: int) -> tuple[np.ndarray, dict]:
    """procedural_sky(height) written as a float16 PIZ EXR and read back
    with load_exr (app.py --skybox's loader): the sky as loaded, and the
    seconds, bytes and the largest difference from the sky rounded to
    float16. Pure host work, run in a worker process."""
    sky = exr.procedural_sky(height=height)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "sky.exr"
        t0 = time.perf_counter()
        exr.write_exr(path, sky, compression="piz", dtype="float16")
        t1 = time.perf_counter()
        back = exr.load_exr(path)
        t2 = time.perf_counter()
        nbytes = path.stat().st_size
    want = sky.astype(np.float16).astype(np.float32)
    return back, {"shape": back.shape, "write_s": t1 - t0, "load_s": t2 - t1,
                  "bytes": nbytes,
                  "max_abs_err_vs_f16": float(np.abs(back - want).max()),
                  "bit_equal_f16": bool(np.array_equal(
                      back.view(np.uint32), want.view(np.uint32)))}


def phase_skybox_exr(pool, sky_job) -> np.ndarray:
    """The EXR round trip's result, which must equal the sky rounded to
    float16 bit for bit. Taken before the first frame timed on the host's
    clock, so the worker's host work overlaps only the kernel checks,
    which CUDA events time, and the flagship capture frame, whose time
    nothing reads; the worker process is then stopped."""
    t0 = time.perf_counter()
    sky, rt = sky_job.result()
    pool.shutdown()
    log("skybox-exr", shape=rt["shape"], write_s=f"{rt['write_s']:.2f}",
        load_s=f"{rt['load_s']:.2f}", mbytes=f"{rt['bytes'] / 1e6:.2f}",
        bit_equal_f16=rt["bit_equal_f16"],
        max_abs_err_vs_f16=rt["max_abs_err_vs_f16"],
        waited_s=f"{time.perf_counter() - t0:.2f}")
    if not rt["bit_equal_f16"] or sky.shape != (SKY_HEIGHT, 2 * SKY_HEIGHT,
                                                3):
        raise RuntimeError("the sky did not round-trip through the EXR "
                           "file within float16")
    return sky


def phase_skybox(model, sky: np.ndarray, dev: torch.device):
    """The ladder scene under the round-tripped sky and its renderer on
    the card: the environment pdf's size, create_renderer's seconds and
    the share of environment RIS words filled."""
    t0 = time.perf_counter()
    scene = build_scene(model, skybox=sky, device=dev)
    t1 = time.perf_counter()
    renderer = fr.create_renderer(scene, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mips = renderer.scene_lights.env_pdf_mips
    env = renderer.ris_buffer[renderer.ris_buffer.shape[0] // 2:]
    filled = float((env[:, 1] != 0).float().mean())
    log("skybox", env_pdf_texture=tuple(mips[0].shape), env_pdf_mips=len(mips),
        build_scene_s=f"{t1 - t0:.2f}", create_renderer_s=f"{t2 - t1:.2f}",
        env_ris_words=env.shape[0], env_ris_filled_share=f"{filled:.6f}")
    if filled == 0.0:
        raise RuntimeError("no environment RIS word is filled")
    return scene, renderer


def on_field(g, field: int):
    """g on checkerboard field 1 or 2 (app.py --checkerboard), or on the
    full grid for field 0."""
    return g.replace(runtime_params=dataclasses.replace(
        g.runtime_params, active_checkerboard_field=field))


def sky_gconst(renderer, view, field: int = 0, frame: int = 0):
    """The flagship config with environment=1 (app.py --skybox), on a
    checkerboard field when field is 1 or 2."""
    return on_field(flagship_gconst(renderer, view, environment=1)
                    .replace(frame=frame), field)


def cb_di_gconst(scene, view, frame: int):
    """The DI validation config (di_gconst) on field 1 + (frame & 1), with
    phase_di_frames' blend factor."""
    return on_field(di_gconst(scene, view).replace(
        frame=frame, blend_factor=1.0 / (frame + 1)), 1 + (frame & 1))


def phase_checkerboard_capture(scene, renderer, view) -> TraceLog:
    """One flagship sky frame on checkerboard field 1 that keeps the inputs
    of the first B1, B3 and B4 launch of each bounce trace, and one frame
    of the DI config on field 1 that keeps those of B2 and B4 on its
    visibility trace (get_conservative_visibility over the [H, W/2]
    grid); each bounce and visibility trace must cast HEIGHT*WIDTH/2
    rays, each G-buffer HEIGHT*WIDTH."""
    trace_log = TraceLog(renderer.tracers)
    bounces = tuple(f"cb_{b}" for b in FLAGSHIP_BOUNCES)
    frames = (("cb_", bounces, sky_gconst(renderer, view, field=1)),
              ("cbdi_", ("cbdi_brdf_candidate",),
               cb_di_gconst(scene, view, frame=0)))
    t0 = time.perf_counter()
    try:
        for prefix, names, g in frames:
            trace_log.start(prefix, names)
            state = fr.init_frame_state(WIDTH, HEIGHT, checkerboard=True,
                                        device=scene.device)
            fr.render_frame(renderer, g, state)
            torch.cuda.synchronize()
            trace_log.stop()
    finally:
        trace_log.restore()
    half = HEIGHT * WIDTH // 2
    want = {"cb_gbuffer": HEIGHT * WIDTH, "cbdi_gbuffer": HEIGHT * WIDTH,
            "cbdi_brdf_candidate": half, "cbdi_visibility": half} | {
        b: half for b in bounces}
    log("checkerboard-capture", seconds=f"{time.perf_counter() - t0:.3f}",
        trace_rays=json.dumps(trace_log.trace_rays, separators=(",", ":")),
        kept=json.dumps({f"{c}:{k}": v[0].shape[0]
                         for (c, k), v in sorted(trace_log.culls.items())},
                        separators=(",", ":")),
        visibility_rays=trace_log.rays,
        blocked_share=f"{trace_log.share():.4f}")
    if trace_log.trace_rays != want:
        raise RuntimeError(f"the checkerboard frames' traces cast "
                           f"{trace_log.trace_rays}, not {want}")
    missing = ({(b, k) for b in bounces for k in CULLS}
               | {("cbdi_visibility", "bundle_union")}) - set(trace_log.culls)
    missing |= set(bounces + ("cbdi_visibility",)) - set(trace_log.walks)
    if missing:
        raise RuntimeError(f"the checkerboard frames launched no cull or "
                           f"walk for {sorted(missing, key=str)}")
    return trace_log


def phase_kernel_checkerboard(renderer, trace_log: TraceLog) -> dict:
    """B1, B3 and B4 against their plain versions on the checkerboard
    frame's half-grid bounce batches, B2 and B4 on the DI frame's
    half-grid visibility batch (each plain walk timed once, it takes
    seconds a batch): {kernel: {class: result}}."""
    real = lane_real(renderer.tracers)
    out = {"walk_closest": {}, "walk_occluded": {}, "nearest_box": {},
           "bundle_union": {}}
    checks = [(f"cb_{b}", k) for b in FLAGSHIP_BOUNCES for k in CULLS]
    checks.append(("cbdi_visibility", "bundle_union"))
    for cls in [f"cb_{b}" for b in FLAGSHIP_BOUNCES] + ["cbdi_visibility"]:
        kernel, args, group, kw = trace_log.walks[cls]
        out[kernel][cls] = check_walk(kernel, cls, args, group, real,
                                      **kw)
    for cls, k in checks:
        out[k][cls] = check_cull(k, cls, trace_log.culls[cls, k])
    return out


def phase_checkerboard_frames(scene, renderer, view) -> dict:
    """CHECKERBOARD_FRAMES sky frames on fields 1, 2, 1, 2 (bench.py's
    at_frame, bench.py:275-281) from a checkerboard state, then
    SKY_FULL_FRAMES full-grid sky frames, then CHECKERBOARD_DI_FRAMES
    frames of the DI config on fields 1, 2; every count is reset just
    before each run, and B1, B3 and B4 (and B2 in the DI run) must have
    launched. Returns the launches of each run."""
    tracers = renderer.tracers
    paths = {}
    runs = (
        ("checkerboard_frames", CHECKERBOARD_FRAMES, True,
         lambda f: sky_gconst(renderer, view, field=1 + (f & 1), frame=f)),
        ("skybox_frames", SKY_FULL_FRAMES, False,
         lambda f: sky_gconst(renderer, view, frame=f)),
        ("checkerboard_di_frames", CHECKERBOARD_DI_FRAMES, True,
         lambda f: cb_di_gconst(scene, view, f)))
    for name, n, checkerboard, gconst in runs:
        state = fr.init_frame_state(WIDTH, HEIGHT, checkerboard=checkerboard,
                                    device=scene.device)
        _reset_counts(tracers)
        seconds = []
        for f in range(n):
            g = gconst(f)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, img = fr.render_frame(renderer, g, state)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            _check_image(f"{name} display", img, display=True)
        background = float((state.gbuffer.depth == BACKGROUND_DEPTH)
                           .float().mean())
        launches = _launches()
        log("checkerboard-frames", run=name,
            seconds=json.dumps([round(x, 3) for x in seconds]),
            background_share=f"{background:.4f}",
            rays_per_frame=count_frame_rays(g, WIDTH, HEIGHT),
            launches=json.dumps(launches, separators=(",", ":")),
            fallback_bundles=json.dumps(
                {str(k): v for k, v in tracers.fallback_by_class.items()},
                separators=(",", ":")))
        _check_image(f"{name} diffuse_lighting", state.diffuse_lighting,
                     display=False)
        need = CULLS + WALKS if name == "checkerboard_di_frames" else (
            "walk_closest",) + CULLS
        for kernel in need:
            if launches[kernel] <= 0:
                raise RuntimeError(f"the {name} never launched {kernel}")
        paths[name] = launches
    return paths


# the function render_frame calls for each FRAME_PASSES name
PASS_FUNCTIONS = {"gbuffer": "gbuffer_pass",
                  "di": "di_fused_resampling_pass",
                  "brdf_rays": "brdf_rays_pass",
                  "shade_secondary": "shade_secondary_surfaces_pass",
                  "gi_temporal": "gi_temporal_pass",
                  "gi_spatial": "gi_spatial_pass",
                  "gi_final": "gi_final_shading_pass",
                  "post": "post_process"}


def _pass_hook(timer: PassTimer, name: str):
    """A _Patch hook that times each call under `name` (synchronised)."""
    def hook(inner, *args, **kwargs):
        with timer.time(name):
            return inner(*args, **kwargs)
    return hook


def _ms(xs) -> dict:
    return {"median": 1e3 * statistics.median(xs), "min": 1e3 * min(xs),
            "max": 1e3 * max(xs)}


def phase_flagship_passes(scene, renderer, g_flag) -> None:
    """The per-pass split of the flagship frame (no sky), on the full grid
    and on checkerboard field 1, two ways. As bench.py's per_pass measures
    it (bench.py:374-393): each FRAME_PASSES prefix
    (render_frame(stop_after=...)) timed PASS_REPEATS times, synchronised,
    with its median, spread and the signed difference of the medians
    (prefix differences carry the spread of two whole prefixes). And
    inside whole frames: each pass's function synchronised and timed in
    the frame (a pass that does not run has no sample), the rest of the
    frame outside them. After one untimed frame the runs take turns (all
    prefixes, then one whole frame), so a drift of the host's speed
    reaches all of them alike."""
    for variant, field in (("full", 0), ("checkerboard", 1)):
        g = on_field(g_flag, field)
        state = fr.init_frame_state(WIDTH, HEIGHT, checkerboard=field != 0,
                                    device=scene.device)
        fr.render_frame(renderer, g, state)
        prefixes, passes = PassTimer(scene.device), PassTimer(scene.device)
        outside = []
        for i in range(PASS_REPEATS):
            g_i = g.replace(frame=i + 1)
            for stop in fr.FRAME_PASSES:
                with prefixes.time(stop):
                    fr.render_frame(renderer, g_i, state, stop_after=stop)
            hooks = [_Patch(fr, PASS_FUNCTIONS[stop], _pass_hook(passes, stop))
                     for stop in fr.FRAME_PASSES]
            before = {k: len(v) for k, v in passes.samples.items()}
            try:
                with passes.time("frame"):
                    fr.render_frame(renderer, g_i, state)
            finally:
                for h in reversed(hooks):
                    h.restore()
            if any(len(passes.samples[k]) != i + 1
                   for k in ("gbuffer", "di", "post")):
                raise RuntimeError("the frame's passes were not timed "
                                   "once each inside it")
            in_passes = sum(sum(v[before.get(k, 0):])
                            for k, v in passes.samples.items()
                            if k != "frame")
            outside.append(passes.samples["frame"][-1] - in_passes)
        prev = 0.0
        for stop in fr.FRAME_PASSES:
            cum = _ms(prefixes.samples[stop])
            runs = passes.samples.get(stop, [])
            inside = _ms(runs) if runs else None
            log("flagship-passes", variant=variant, stop_after=stop,
                cumulative_ms=f"{cum['median']:.2f}",
                cumulative_spread_ms=f"{cum['min']:.2f}-{cum['max']:.2f}",
                difference_ms=f"{cum['median'] - prev:.2f}",
                in_frame_ms=(f"{inside['median']:.2f}" if inside
                             else "not run"),
                in_frame_spread_ms=(f"{inside['min']:.2f}-{inside['max']:.2f}"
                                    if inside else "not run"))
            prev = cum["median"]
        frame = _ms(passes.samples["frame"])
        log("flagship-passes", variant=variant,
            frame_ms=f"{frame['median']:.2f}",
            frame_spread_ms=f"{frame['min']:.2f}-{frame['max']:.2f}",
            outside_passes_ms=f"{1e3 * statistics.median(outside):.2f}",
            whole_prefix_ms=f"{prev:.2f}",
            rays_per_frame=count_frame_rays(g, WIDTH, HEIGHT))


def phase_frames(scene, renderer, g) -> dict:
    """One reference-mode render_frame (12 spp, 5 bounces, its defaults)
    and one render_reference frame at bench's ladder cell (8 spp)."""
    tracers = renderer.tracers
    state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
    _reset_counts(tracers)
    runs = (("render_frame", 12), ("render_reference", 8))
    for name, spp in runs:
        bounces = 5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "render_frame":
            state, img = fr.render_frame(renderer, g.replace(frame=0), state)
            live = None
        else:
            img, live = render_reference(
                scene, g.replace(frame=1), WIDTH, HEIGHT,
                max_bounces=bounces, max_samples=spp,
                trace_fn=tracers.closest_hit, with_ray_count=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log(name, spp=spp, bounces=bounces, seconds=f"{sec:.3f}",
            nominal_mrays_per_s=f"{WIDTH * HEIGHT * spp * bounces / sec / 1e6:.3f}",
            live_rays=live,
            launches=json.dumps(_launches(), separators=(",", ":")),
            fallback_bundles=tracers.fallback_bundles,
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        _check_image(f"{name} output", img, display=name == "render_frame")
    launches = _launches()
    if launches["walk_closest"] <= 0:
        raise RuntimeError("the reference path never launched the walk")
    return launches


# ---------------------------------------------------------------------------
# The pair-sweep backend (B5, B6)
# ---------------------------------------------------------------------------

def phase_pairs_scene(scene):
    """The pair-sweep renderer on the same scene: its superclusters, lanes
    and the bytes of its tables."""
    t0 = time.perf_counter()
    renderer = fr.create_renderer(scene, WIDTH, HEIGHT, backend="pairs")
    torch.cuda.synchronize()
    ps = renderer.tracers.pair_scene
    nbytes = sum(x.numel() * x.element_size()
                 for x in (ps.sc_min, ps.sc_max, ps.wald_sc, ps.meta_rows))
    log("pairs-scene", superclusters=ps.num_superclusters, group=ps.group,
        lanes=ps.lanes, slot_mask=cp._slot_mask(ps.lanes),
        k_cand=app_bridge.PAIR_K_CAND, ray_batch=cp.PAIR_RAY_BATCH,
        table_mbytes=f"{nbytes / 1e6:.2f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return renderer


def phase_pairs_capture(scene, renderer, g_flag, g_di,
                        trace_log: TraceLog) -> None:
    """One flagship and one DI frame through the pairs backend that keep
    the inputs of the first B5 and B6 launch of each trace call and each
    trace call's rays (they also warm the path up)."""
    tracers = renderer.tracers
    seconds = {}
    for name, g, bounces in (
            ("flagship", g_flag.replace(frame=0),
             tuple(f"pairs_flagship_{b}" for b in FLAGSHIP_BOUNCES)),
            ("di", g_di.replace(frame=0, blend_factor=1.0),
             ("pairs_di_brdf_candidate",))):
        trace_log.start(f"pairs_{name}_", bounces)
        state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
        t0 = time.perf_counter()
        fr.render_frame(renderer, g, state)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)
    trace_log.stop()
    traces = [f"pairs_flagship_{b}" for b in ("gbuffer",) + FLAGSHIP_BOUNCES]
    traces.append("pairs_di_visibility")
    missing = {(t, k) for t in traces for k in PAIR_KERNELS} - set(
        trace_log.pair_kernels)
    if missing:
        raise RuntimeError(f"the pairs frames launched no {sorted(missing)}")
    log("pairs-capture", seconds=json.dumps(seconds, separators=(",", ":")),
        kept=json.dumps({k: v[0].shape[0]
                         for k, v in sorted(trace_log.traces.items())},
                        separators=(",", ":")),
        fallback_rays=json.dumps(
            {str(k): v for k, v in tracers.fallback_by_class.items()},
            separators=(",", ":")))


def real_lanes_by_sc(ps: cp.PairScene) -> torch.Tensor:
    """[C2] i64: the real triangles of each supercluster."""
    per_cluster = (ps.meta_rows[:, 12] >= 0).reshape(-1, ps.s_pad).sum(1)
    pad = ps.num_superclusters * ps.group - per_cluster.numel()
    return torch.nn.functional.pad(per_cluster, (0, pad)).reshape(
        ps.num_superclusters, ps.group).sum(1)


def pair_sweep_bound(args, real_sc) -> dict:
    """The least time the card could take for one pair_sweep call on these
    inputs: the larger of (bytes) / HBM rate and (FP32 operations) / FP32
    rate. Operations: WALD_TEST_OPS per (active pair ray, real triangle of
    its block's supercluster), an active pair ray being one of a live block
    whose segment is not empty (dead pairs carry t_max = -1). Bytes: the
    pair rows and block tables read once, the keys written once, the Wald
    coefficients (12 floats) of each real triangle of each distinct live
    supercluster read once."""
    rays8, block_sc, block_live, _ = args
    nblk = block_sc.numel()
    live = block_live != 0
    rows = rays8.reshape(nblk, cp.PAIR_P, 8)
    active = ((rows[..., 7] > rows[..., 6]) & live[:, None]).sum(1)
    tests = int((active * real_sc[block_sc.long()]).sum())
    sc_used = torch.unique(block_sc[live]).long()
    nbytes = (rays8.numel() * 4 + nblk * 2 * 4 + rays8.shape[0] * 4
              + int(real_sc[sc_used].sum()) * 12 * 4)
    ops = tests * WALD_TEST_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "active_pair_rays": int(active.sum()),
            "live_blocks": int(live.sum()),
            "superclusters_swept": int(sc_used.numel())}


def check_pair_sweep(cls: str, args, kwargs, real_sc, tally) -> dict:
    """pair_sweep against its plain version on a trace's first batch: keys
    bit for bit, both times (CUDA events) and the bound; with the trace's
    tally of every batch (TraceLog.checked). kwargs: the kernel's own table
    (lanes). Raises on any mismatch, or on a trace that hits nothing in all
    its batches."""
    got = cp.pair_sweep(*args, **kwargs)
    want = cp.pair_sweep_reference(*args)
    plain_ms = _plain_ms(lambda: cp.pair_sweep_reference(*args))
    ms = _median_ms(lambda: cp.pair_sweep(*args, **kwargs))
    bound = pair_sweep_bound(args, real_sc)
    batches, mismatches, hits = tally
    mismatches += int((got != want).sum())
    share = _bound_share("pair_sweep", cls, bound["bound_ms"], ms)
    log("kernel-pairs", kernel="pair_sweep", cls=cls, pairs=got.numel(),
        blocks=args[1].numel(), live_blocks=bound["live_blocks"],
        active_pair_rays=bound["active_pair_rays"],
        superclusters_swept=bound["superclusters_swept"],
        first_batch_hits=int((want < cp.MISS_KEY).sum()),
        batches_checked=batches, hits_all_batches=hits,
        mismatches=mismatches, kernel_ms=f"{ms:.3f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound['bound_ms']:.4f}",
        bound_by=bound["bound_by"],
        bound_share=f"{share:.3f}",
        mbytes=f"{bound['bytes'] / 1e6:.2f}",
        gops=f"{bound['ops'] / 1e9:.3f}")
    if mismatches:
        raise RuntimeError(f"pair_sweep ({cls}): kernel and plain version "
                           f"disagree on {mismatches} keys")
    if hits == 0:
        raise RuntimeError(f"pair_sweep ({cls}): no batch hits anything, "
                           "they test nothing")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "mismatches": mismatches,
            "max_abs_err": int((got.long() - want.long()).abs().max()),
            **bound}


def check_bin(cls: str, ids, n_bins: int, kwargs,
              tally=(0, 0, 0)) -> dict:
    """bin_scatter against its plain version on one id array (a trace's
    first batch, or the probe's): slots, counts and (when asked) ranks bit
    for bit. Times, all in this run: the kernel's (CUDA events around one
    call, as every kernel here is timed), its plain version's and
    torch.argsort(stable=True)'s on the same ids; and graph_ms, the card's
    time alone (one replay of the call captured in a CUDA graph, the L2
    written over before it, its output held to the plain version's:
    tools/bin_scatter_ab.py). The bound, bytes: the ids read once, the
    slots (and ranks) written once. A trace's tally of every batch
    (TraceLog.checked) adds its mismatches."""
    got = binning.bin_scatter(ids, n_bins, **kwargs)
    want = binning.bin_scatter_reference(ids, n_bins, **kwargs)
    torch.cuda.synchronize()
    fields = [(g, w) for g, w in zip(got, want) if w is not None]
    mismatches = tally[1] + sum(int((g != w).sum()) for g, w in fields)
    max_abs = max(int((g.long() - w.long()).abs().max()) if w.numel() else 0
                  for g, w in fields)
    ms = _median_ms(lambda: binning.bin_scatter(ids, n_bins, **kwargs))
    graph_ms = bin_scatter_ab.graph_ms(
        lambda: binning.bin_scatter(ids, n_bins, **kwargs), want)
    plain_ms = _median_ms(
        lambda: binning.bin_scatter_reference(ids, n_bins, **kwargs), reps=3)
    library_ms = _median_ms(lambda: torch.argsort(ids, stable=True))
    n = ids.numel()
    nbytes = (n * 4 + kwargs.get("out_size", 0) * 4 + n_bins * 4
              + (n * 4 if kwargs.get("ranks") else 0))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    stored = int((got.slots >= 0).sum())
    log("kernel-pairs", kernel="bin_scatter", cls=cls, ids=n, bins=n_bins,
        slots=got.slots.numel(), stored=stored,
        bins_used=int((got.counts > 0).sum()), batches_checked=tally[0],
        stored_all_batches=tally[2], mismatches=mismatches,
        kernel_ms=f"{ms:.4f}", graph_ms=f"{graph_ms:.4f}",
        plain_ms=f"{plain_ms:.3f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by="bytes",
        bound_share=f"{_bound_share('bin_scatter', cls, bound_ms, ms):.3f}",
        graph_bound_share=(
            f"{_bound_share('bin_scatter', cls, bound_ms, graph_ms):.3f}"),
        mbytes=f"{nbytes / 1e6:.2f}")
    if mismatches:
        raise RuntimeError(f"bin_scatter ({cls}): kernel and plain version "
                           f"disagree on {mismatches} values")
    if int(got.counts.sum()) == 0:
        raise RuntimeError(f"bin_scatter ({cls}): no id in any bin")
    if DUMP_BIN is not None:
        DUMP_BIN.mkdir(parents=True, exist_ok=True)
        torch.save({"cls": cls, "ids": ids.cpu(), "n_bins": n_bins,
                    "kwargs": dict(kwargs)}, DUMP_BIN / f"{cls}.pt")
    return {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "mismatches": mismatches, "max_abs_err": max_abs,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes}


def phase_kernel_pairs(renderer, trace_log: TraceLog) -> dict:
    """B5 and B6 against their plain versions on each trace's first batch
    (timed; the capture held every batch), and B6 (and the probe built on
    it) on PROBE_IDS ids in PROBE_BINS bins: {kernel: {class: result}}."""
    real_sc = real_lanes_by_sc(renderer.tracers.pair_scene)
    out = {k: {} for k in PAIR_KERNELS}
    for (cls, kernel), (args, kwargs) in sorted(
            trace_log.pair_kernels.items()):
        tally = trace_log.checked[cls, kernel]
        if kernel == "pair_sweep":
            out[kernel][cls] = check_pair_sweep(cls, args, kwargs, real_sc,
                                                tally)
        else:
            out[kernel][cls] = check_bin(cls, *args, kwargs, tally)
    gen = torch.Generator(device=renderer.scene.device).manual_seed(6)
    ids = torch.randint(0, PROBE_BINS, (PROBE_IDS,), generator=gen,
                        device=renderer.scene.device, dtype=torch.int32)
    out["bin_scatter"]["probe"] = check_bin("probe", ids, PROBE_BINS,
                                            {"ranks": True})
    got = binning.scatter_rate_probe(ids, n_bins=PROBE_BINS)
    want = binning.scatter_rate_probe(ids.cpu(), n_bins=PROBE_BINS)
    same = bool((got.cpu() == want).all())
    log("kernel-pairs", kernel="scatter_rate_probe", ids=PROBE_IDS,
        bins=PROBE_BINS, blocks=got.shape[0], equal_to_plain=same,
        first=json.dumps(got[:4, 0].tolist()))
    if not same:
        raise RuntimeError("scatter_rate_probe: kernel and plain differ")
    return out


def _backends_agree(phase: str, scene, renderer, name, rays, got,
                    ref) -> dict:
    """The pair engine's answer `got` for a kept trace's rays against the
    bundle walk's `ref`: a hit that differs must be a key tie (KEY_TIE_REL:
    the same miss flag and t equal above the bits the packed keys drop, so
    the lane slot picked the winner), a blocked flag that differs a
    rounding tie (_rounding_ties). Returns the counts to log; raises on
    any other difference."""
    o, d, tn, tx = rays
    if name.endswith("visibility"):
        differ = torch.nonzero(got != ref).reshape(-1)
        if differ.numel() > ORACLE_RAYS:
            raise RuntimeError(f"{phase} {name}: {differ.numel()} blocked "
                               "flags differ between the backends")
        r = tuple(x[differ] for x in (o, d, tn, tx))
        ties = _rounding_ties(scene, renderer.tracers, r, got[differ])
        tied = ties.pop("tied")
        bad = int((~tied).sum())
        fields = dict(blocked=int(got.sum()), differ=differ.numel(),
                      ties=int(tied.sum()), **ties, disagree=bad)
    else:
        differ = got.triangle_index != ref.triangle_index
        rel = (got.t - ref.t).abs() / ref.t.abs()
        tie = differ & (got.missed == ref.missed) & (rel <= KEY_TIE_REL)
        bad_rays = torch.nonzero(differ & ~tie).reshape(-1)
        bad = bad_rays.numel()
        fields = dict(
            hits=int((~got.missed).sum()), differ=int(differ.sum()),
            key_ties=int(tie.sum()),
            max_tie_rel_t=f"{float(rel[tie].max()) if tie.any() else 0:.3g}",
            disagree=bad, first_disagreeing=json.dumps([
                [int(i), float(got.t[i]), float(ref.t[i]),
                 int(got.triangle_index[i]), int(ref.triangle_index[i])]
                for i in bad_rays[:4].tolist()]))
    if bad:
        log(phase, trace=name, **fields)
        raise RuntimeError(f"{phase} {name}: {bad} rays differ between the "
                           "backends beyond ties")
    return fields


def _per_ray(trace):
    """A kept trace's rays with per-ray t_min and t_max."""
    o, d, tn, tx, _ = trace
    return (o, d) + tuple(torch.as_tensor(t, device=o.device).expand(
        o.shape[0]) for t in (tn, tx))


def phase_pairs_ties(scene, renderer, renderer_p,
                     trace_log: TraceLog) -> dict:
    """Each trace the pairs frames kept, through both backends; every
    difference must be a tie (_backends_agree). Also logs, per trace, the
    most superclusters one ray overlaps and how many rays overlap more than
    the tracers' k_cand (any one sends the trace to the fallback). Returns
    {trace: the most superclusters one ray overlaps}."""
    ps = renderer_p.tracers.pair_scene
    max_overlap = {}
    for name, trace in sorted(trace_log.traces.items()):
        o, d, tn, tx, presorted = trace
        rays = _per_ray(trace)
        overlap = torch.cat([
            cp._slab_entry(ps, *(x[s:s + cp.PAIR_RAY_BATCH] for x in rays))[1]
            for s in range(0, o.shape[0], cp.PAIR_RAY_BATCH)])
        max_overlap[name] = int(overlap.max())
        log("pairs-overlap", trace=name, rays=o.shape[0],
            max_superclusters=max_overlap[name],
            mean_superclusters=f"{float(overlap.float().mean()):.3f}",
            rays_over_k=int((overlap > app_bridge.PAIR_K_CAND).sum()),
            k_cand=app_bridge.PAIR_K_CAND)
        query = "occluded" if name.endswith("visibility") else "closest_hit"
        got, ref = (getattr(r.tracers, query)(o, d, tn, tx,
                                              presorted=presorted)
                    for r in (renderer_p, renderer))
        log("pairs-ties", trace=name, rays=o.shape[0],
            **_backends_agree("pairs-ties", scene, renderer, name, rays, got,
                              ref))
    return max_overlap


def _wall_median_ms(fn, reps: int = NO_OVERFLOW_REPEATS) -> float:
    """Median host time of fn between synchronisations, in ms, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _parts_ms(fn, parts) -> dict:
    """One more call of fn with each (owner, attr, name) part synchronised
    and timed (_timed): {name: ms summed over its calls, name + "_calls"}."""
    spent, calls = {}, {}

    def count(name):
        def hook(inner, *args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return _timed(spent, lambda kw: name)(inner, *args, **kwargs)
        return hook

    wraps = [_Patch(owner, attr, count(name)) for owner, attr, name in parts]
    try:
        fn()
    finally:
        for w in reversed(wraps):
            w.restore()
    out = {f"{k}_ms": f"{v * 1e3:.3f}" for k, v in sorted(spent.items())}
    out.update({f"{k}_calls": v for k, v in sorted(calls.items())})
    return out


def phase_pairs_no_overflow(scene, renderer, renderer_p,
                            trace_log: TraceLog, max_overlap: dict) -> None:
    """Each of NO_OVERFLOW_TRACES through the pair engine alone
    (closest_hit_pairs / occluded_pairs, no fallback) at k_cand = K, the
    smallest multiple of 8 at or above the most superclusters one of its
    rays overlaps (pairs-ties' count): no ray may overflow, and the answer
    must equal the bundle walk's up to ties (_backends_agree). Logs K, the
    median of NO_OVERFLOW_REPEATS synchronised traces of each backend on
    the same rays, and from one more trace of each B5's and B6's time (the
    pair engine) and the walk's (the bundle engine), each launch
    synchronised."""
    tp, tb = renderer_p.tracers, renderer.tracers
    for name in NO_OVERFLOW_TRACES:
        trace = trace_log.traces[name]
        o, d, tn, tx, presorted = trace
        k = -(-max_overlap[name] // 8) * 8
        visibility = name.endswith("visibility")
        engine = cp.occluded_pairs if visibility else cp.closest_hit_pairs
        walk = "walk_occluded" if visibility else "walk_closest"

        def pairs():
            return engine(tp.pair_scene, tp.clusters, tp.tables, o, d, tn, tx,
                          tp.scene_min, tp.scene_max, k_cand=k,
                          fallback=False)

        def bundle():
            query = tb.occluded if visibility else tb.closest_hit
            return query(o, d, tn, tx, presorted=presorted)

        got, overflowed = pairs()
        if overflowed:
            raise RuntimeError(f"pairs-no-overflow {name}: a ray overlaps "
                               f"more than k_cand = {k} superclusters")
        agree = _backends_agree("pairs-no-overflow", scene, renderer, name,
                                _per_ray(trace), got, bundle())
        pairs_ms, bundle_ms = _wall_median_ms(pairs), _wall_median_ms(bundle)
        log("pairs-no-overflow", trace=name, rays=o.shape[0], k_cand=k,
            max_superclusters=max_overlap[name], overflowed=overflowed,
            **agree, pairs_ms=f"{pairs_ms:.2f}",
            bundle_ms=f"{bundle_ms:.2f}",
            pairs_over_bundle=f"{pairs_ms / bundle_ms:.3f}",
            **_parts_ms(pairs, [(cp, "pair_sweep", "b5_pair_sweep"),
                                (binning, "bin_scatter", "b6_bin_scatter")]),
            **_parts_ms(bundle, [(ct, walk, f"bundle_{walk}")]))


def _pixels_differing(img, ref, against: str = "bundle") -> dict:
    """The pixels of `img` that differ from `ref` (the `against` frame)
    in any bit, those with a channel beyond the goldens' rtol=atol=2e-3,
    and the largest difference."""
    differ = (img != ref).any(dim=-1)
    beyond = ~torch.isclose(img, ref, rtol=IMAGE_TOL,
                            atol=IMAGE_TOL).all(dim=-1)
    return {f"pixels_differing_from_{against}": int(differ.sum()),
            f"pixels_beyond_tol_from_{against}": int(beyond.sum()),
            "max_abs_diff": f"{float((img - ref).abs().max()):.6g}"}


def phase_pairs_frames(scene, renderer, g_flag, g_di, flag_imgs,
                       di_imgs) -> dict:
    """PAIRS_FLAGSHIP_FRAMES flagship frames and one DI frame through the
    pairs backend, each from a fresh state and timed; every count is reset
    just before them, and B5 and B6 must have launched. Each display is
    compared with the bundle backend's frame of the same index."""
    tracers = renderer.tracers
    _reset_counts(tracers)
    runs = [("flagship", g_flag.replace(frame=f), flag_imgs[f])
            for f in range(PAIRS_FLAGSHIP_FRAMES)]
    runs.append(("di", g_di.replace(frame=0, blend_factor=1.0), di_imgs[0]))
    state = None
    for config, g, ref in runs:
        if state is None or config == "di":
            state = fr.init_frame_state(WIDTH, HEIGHT, device=scene.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, img = fr.render_frame(renderer, g, state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log("pairs-frame", config=config, frame=int(g.frame),
            seconds=f"{sec:.3f}",
            launches=json.dumps(_launches(), separators=(",", ":")),
            fallback_rays=json.dumps(
                {str(k): v for k, v in tracers.fallback_by_class.items()},
                separators=(",", ":")),
            **_pixels_differing(img, ref),
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        _check_image(f"pairs {config} display", img, display=True)
    _check_image("pairs di diffuse_lighting", state.diffuse_lighting,
                 display=False)
    launches = _launches()
    for name in PAIR_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"the pairs frames never launched {name}")
    return launches


def phase_pairs_breakdown(scene, renderer, g_flag) -> None:
    """Where a pairs flagship frame's time goes: one more frame with each
    trace split into the slab test, the binning (slab test, top-k and B6),
    B6, B5 and the decode, and one under torch.profiler."""
    _breakdown("pairs", scene, renderer, g_flag.replace(
        frame=PAIRS_FLAGSHIP_FRAMES), [
        (cp, "bin_pairs", "bin_pairs"),
        (cp, "_slab_entry", "slab"),
        (binning, "bin_scatter", "b6_bin_scatter"),
        (cp, "pair_sweep", "b5_pair_sweep"),
        (ct, "_decode", "decode")], nested=("slab", "b6_bin_scatter"))


def phase_sharded(renderer) -> None:
    """The frame row-sharded over torch.distributed ranks
    (parallel/mesh.py, parallel/dryrun.py), on the ladder at 1920x1080
    with the dry run's flagship configuration (GI temporal and spatial
    resampling on): (a) one NCCL rank on the card, two frames; (b) two
    gloo ranks sharing the card, 540 rows each, two frames and one
    checkerboard frame (field 1) with DI temporal resampling. Every frame
    is gathered and held to render_frame's unsharded frame of the same
    index rendered here (the JAX dry run's bar: more than 95% of the
    pixels bit-exact, a mean |diff| below 1e-3); each rank's frame times,
    halo telemetry and B1/B2/B3/B4 launches are logged, and B1, B3 and B4
    must have launched inside every rank. A rank that fails or misses the
    deadline fails the phase; all render on the card."""
    with tempfile.TemporaryDirectory() as d:
        glb = Path(d) / "ladder.glb"
        proc.write_glb(glb, proc.corridor_glb(**LADDER))
        jobs = {backend: (n, dryrun.Job(
            glb=str(glb), width=WIDTH, height=HEIGHT, position=CAMERA_POS,
            direction=CAMERA_DIR, device="cuda", backend=backend,
            flagship_frames=frames, checkerboard_frames=cb))
            for backend, (n, frames, cb) in SHARDED_RUNS.items()}
        # (b)'s frames include (a)'s
        ref = dryrun.render_unsharded(jobs["gloo"][1], renderer)
        for backend, (n, job) in jobs.items():
            t0 = time.perf_counter()
            ranks = dryrun.run_ranks(job, n, timeout=SHARDED_TIMEOUT_S)
            log("sharded", run=backend, ranks=n,
                seconds=f"{time.perf_counter() - t0:.1f}")
            for name, frames in ranks[0]["configs"].items():
                for f, img in enumerate(frames["images"]):
                    stats = dryrun.parity(img, ref[name][f])
                    log("sharded", run=backend, config=name, frame=f,
                        bit_exact=f"{stats['bit_exact']:.6f}",
                        mean_abs_diff=f"{stats['mean_abs_diff']:.3e}",
                        **_pixels_differing(torch.from_numpy(img),
                                            torch.from_numpy(ref[name][f]),
                                            against="unsharded"))
                    if not np.isfinite(img).all() or img.max() <= 0.05:
                        raise RuntimeError(f"sharded {backend} {name} frame "
                                           f"{f}: not finite or not lit")
                    dryrun.check(stats, f"sharded {backend} {name} frame {f}")
            for r, out in enumerate(ranks):
                for name, frames in out["configs"].items():
                    log("sharded-rank", run=backend, rank=r, config=name,
                        row0=out["row0"], rows=out["rows"],
                        device=out["device"],
                        seconds=json.dumps([round(s, 4)
                                            for s in frames["seconds"]]),
                        telemetry=json.dumps(frames["telemetry"],
                                             separators=(",", ":")),
                        launches=json.dumps(frames["launches"],
                                            separators=(",", ":")))
                    idle = [k for k in SHARDED_COUNTED
                            if frames["launches"][k] == 0]
                    if idle:
                        raise RuntimeError(f"sharded {backend} rank {r} "
                                           f"{name}: {idle} never launched")


def kernel_entry(name: str, classes: dict, launches: int,
                 by_path: dict, occupancy: dict | None) -> dict:
    t = _totals(classes)
    library = [c.get("library_ms") for c in classes.values()]
    extra = {"occupancy": occupancy} if occupancy else {}
    return {"name": name, "route": "cuda", **KERNELS[name],
            "launches": launches, "launches_by_path": by_path, **extra,
            "max_abs_err": t["max_abs_err"], "mismatches": t["mismatches"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # torch.argsort(stable=True) on the same ids for the binning;
            # no single PyTorch call computes a bundle walk, a slab-test
            # argmin over boxes, a per-bundle slab-test union or a pair sweep
            "library_ms": (sum(library) if None not in library else None),
            "classes": t["classes"]}


def main() -> None:
    global DUMP_BIN
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(
        description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--dump-bin", type=Path, metavar="DIR",
                    help="save each B6 input that kernel-pairs checks "
                         "(tools/bin_scatter_ab.py reads them)")
    DUMP_BIN = ap.parse_args().dump_bin
    dev, smi = phase_device()
    # the skybox's EXR round trip is pure-Python host work (tens of seconds
    # at 2048x1024): a worker process runs it beside the kernel checks
    pool = ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        run(dev, smi, pool, pool.submit(exr_round_trip, SKY_HEIGHT),
            t_start)
    finally:
        pool.shutdown(cancel_futures=True)


def run(dev: torch.device, smi: str, pool, sky_job,
        t_start: float) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    scene, renderer, view, model = phase_scene(dev)
    renderer_p = phase_pairs_scene(scene)
    occupancy = phase_occupancy(renderer, renderer_p)
    g_ref, g_di = reference_gconst(scene, view), di_gconst(scene, view)

    batches = main_path_batches(scene, renderer, g_ref)
    classes = {"walk_closest": phase_kernel(renderer, batches)}
    phase_oracle(scene, renderer, batches)
    phase_oracle(scene, renderer_p, batches, phase="oracle-pairs")
    del batches

    trace_log = TraceLog(renderer.tracers)
    phase_capture(scene, renderer, g_di, trace_log)
    for kernel, by_cls in phase_kernel_di(renderer, trace_log).items():
        classes.setdefault(kernel, {}).update(by_cls)
    phase_oracle_occlude(scene, renderer, trace_log.oracle_rays)
    phase_oracle_occlude(scene, renderer_p, trace_log.oracle_rays,
                         phase="oracle-pairs")
    trace_log.walks.clear()
    oracle_rays, trace_log.oracle_rays = trace_log.oracle_rays, None
    g_flag = flagship_gconst(renderer, view)
    phase_flagship_capture(scene, renderer, g_flag, trace_log)
    classes["walk_closest"].update(phase_kernel_flagship(renderer,
                                                         trace_log))
    trace_log.walks.clear()
    classes.update(phase_kernel_cull(trace_log))
    trace_log.culls.clear()
    sky = phase_skybox_exr(pool, sky_job)
    paths = {}
    paths["di_frames"], di_imgs = phase_di_frames(scene, renderer, g_di,
                                                  trace_log)
    phase_di_breakdown(scene, renderer, g_di)
    paths["flagship_frames"], flag_imgs, flag_seconds = \
        phase_flagship_frames(scene, renderer, g_flag)
    phase_flagship_breakdown(scene, renderer, g_flag)
    phase_gi_resampling(scene, renderer, view)
    paths["di_resampling_frames"], rs_classes = phase_di_resampling(
        scene, renderer)
    for kernel, by_cls in rs_classes.items():
        classes[kernel].update(by_cls)
    paths["regir_frames"] = phase_regir(scene, view)
    paths["k_cand_probe"], paths["k_cand_frame"] = phase_k_cand(
        scene, renderer, view, g_flag, flag_imgs[0])
    renderer_l = phase_lbvh_build(scene)
    phase_oracle_lbvh(scene, renderer, renderer_l,
                      main_path_batches(scene, renderer, g_ref), oracle_rays)
    paths["lbvh_frames"] = phase_lbvh_frames(scene, renderer_l, g_flag, g_di,
                                             flag_imgs, di_imgs)
    del renderer_l, oracle_rays
    paths["app_frames"] = phase_app(dev, flag_seconds)
    phase_viewer(scene, renderer)

    sky_scene, sky_renderer = phase_skybox(model, sky, dev)
    del model, sky
    cb_log = phase_checkerboard_capture(sky_scene, sky_renderer, view)
    for kernel, by_cls in phase_kernel_checkerboard(sky_renderer,
                                                    cb_log).items():
        classes[kernel].update(by_cls)
    del cb_log
    paths.update(phase_checkerboard_frames(sky_scene, sky_renderer, view))
    del sky_scene, sky_renderer
    phase_flagship_passes(scene, renderer, g_flag)
    paths["reference_frames"] = phase_frames(scene, renderer, g_ref)

    pair_log = TraceLog(renderer_p.tracers, pairs=True)
    phase_pairs_capture(scene, renderer_p, g_flag, g_di, pair_log)
    pair_log.restore()
    classes.update(phase_kernel_pairs(renderer_p, pair_log))
    max_overlap = phase_pairs_ties(scene, renderer, renderer_p, pair_log)
    phase_pairs_no_overflow(scene, renderer, renderer_p, pair_log,
                            max_overlap)
    del pair_log
    paths["pairs_frames"] = phase_pairs_frames(scene, renderer_p, g_flag,
                                               g_di, flag_imgs, di_imgs)
    del flag_imgs, di_imgs
    phase_pairs_breakdown(scene, renderer_p, g_flag)
    del renderer_p
    phase_sharded(renderer)

    # each kernel's launches on its main path: the flagship frames, the DI
    # frames for the any-hit walk (the flagship frame casts no visibility
    # ray), the pairs frames for B5 and B6
    main_path = {name: "di_frames" if name == "walk_occluded"
                 else "pairs_frames" if name in PAIR_KERNELS
                 else "flagship_frames" for name in KERNELS}
    log("run", wall_seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        kernel_entry(name, classes[name], paths[main_path[name]][name],
                     {path: counts[name] for path, counts in paths.items()},
                     occupancy.get(name))
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
