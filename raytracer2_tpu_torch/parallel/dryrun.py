"""Multi-rank dry run, the port's twin of __graft_entry__.py::
dryrun_multichip: N ranks render row tiles of a frame through
parallel/mesh.py and the gathered frames are held to the unsharded ones.

    python -m raytracer2_tpu_torch.parallel.dryrun [--ranks 2]
        [--width 64] [--height 64] [--backend nccl|gloo] [--device cuda|cpu]

Ranks are processes started with torch.multiprocessing (spawn) that meet
through a FileStore in a temporary directory. Two configurations are
rendered, as the JAX dry run renders them: the Cornell box's ReSTIR DI+GI
frame with GI temporal and spatial resampling, and a checkerboard frame
(field 1) with DI temporal resampling. Each must have more than 95% of
its pixels bit-exact and a mean |diff| below 1e-3 against the frame the
calling process renders unsharded. JAX's GSPMD leg is not ported.

Everything renders on --device (default cuda; the run fails rather than
fall back when no CUDA device is present). The backend is named, never
guessed: "nccl" (the default) when each rank has a card of its own,
"gloo" when ranks share one (NCCL refuses two ranks on one device; gloo's
transfers then go through host copies) and on the CPU:

    python -m raytracer2_tpu_torch.parallel.dryrun --device cpu --backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.ops import cull
from raytracer2_tpu_torch.ops import cuda_traverse as ct
from raytracer2_tpu_torch.parallel import mesh as pm
from raytracer2_tpu_torch.params import default_gconst
from raytracer2_tpu_torch.render.frame import (
    create_renderer, init_frame_state, render_frame)
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.camera import default_camera
from raytracer2_tpu_torch.scene.scene import build_scene

# JAX's dry-run bar (__graft_entry__.py:126-127, :151-152)
MIN_BIT_EXACT = 0.95
MAX_MEAN_DIFF = 1e-3
JOIN_TIMEOUT_S = 900.0
CORNELL_CAMERA = ((0, 0, -12), (0, 0, -1))  # __graft_entry__._build_renderer
COUNTED = ("walk_closest", "walk_occluded", "nearest_box", "bundle_union")


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank renders: the scene file, the image, the device type
    ("cuda" or "cpu"; rank r takes card r modulo the cards present), the
    process group's backend ("nccl" or "gloo"), the camera, and the frames
    of each configuration (flagship: ReSTIR DI+GI with GI temporal and
    spatial resampling; checkerboard: field 1 with DI temporal
    resampling). The device and the backend have no default."""

    glb: str
    width: int
    height: int
    device: str
    backend: str
    position: tuple = CORNELL_CAMERA[0]
    direction: tuple = CORNELL_CAMERA[1]
    flagship_frames: int = 1
    checkerboard_frames: int = 1


def write_cornell(path) -> str:
    proc.write_glb(path, proc.cornell_box_glb(light_emission=2.0))
    return str(path)


def flagship_gconst(renderer, view):
    """The JAX dry run's frame: DI and GI on, GI temporal and spatial
    resampling on (__graft_entry__._build_renderer)."""
    return default_gconst(view, renderer.scene_lights.num_local_lights,
                          enable_restir_gi=1, enable_restir_di=1,
                          enable_temporal_resampling=1,
                          enable_spatial_resampling=1)


def checkerboard_gconst(g):
    """The JAX dry run's second frame: checkerboard field 1 with DI
    temporal resampling."""
    return g.replace(
        enable_di_resampling=1, runtime_params=dataclasses.replace(
            g.runtime_params, active_checkerboard_field=1))


def frame_plan(renderer, job: Job) -> dict:
    """{name: (checkerboard, [GConst per frame])} of the job."""
    cam = default_camera(window_size=(job.width, job.height),
                         position=job.position, direction=job.direction)
    g = flagship_gconst(renderer, cam.planar_view_constants())
    cb = checkerboard_gconst(g)
    return {
        "flagship": (False, [g.replace(frame=f)
                             for f in range(job.flagship_frames)]),
        "checkerboard": (True, [cb.replace(frame=f)
                                for f in range(job.checkerboard_frames)]),
    }


def _device(job: Job, rank: int) -> torch.device:
    if job.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the job renders on cuda and no card is "
                               "available to this process")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(job.device)


def _renderer(job: Job, dev: torch.device):
    scene = build_scene(gltf.load_file(job.glb), device=dev)
    return create_renderer(scene, job.width, job.height)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launches() -> dict:
    """The launch counts of the bundle walks' and the cull's kernels
    (B1, B2, B3, B4), as their wrappers keep them."""
    mods = {"walk_closest": ct, "walk_occluded": ct, "nearest_box": cull,
            "bundle_union": cull}
    return {k: getattr(mods[k], k).launches for k in COUNTED}


def render_unsharded(job: Job, renderer=None) -> dict:
    """{name: [display image per frame]} of the job, rendered whole by
    render_frame in this process (numpy [H, W, 3]), through `renderer`
    (one of the job's scene and size) or one built from the job."""
    if renderer is None:
        renderer = _renderer(job, _device(job, 0))
    dev = renderer.scene.device
    out = {}
    for name, (cb, gs) in frame_plan(renderer, job).items():
        out[name] = []
        if not gs:
            continue
        state = init_frame_state(job.width, job.height, cb, device=dev)
        for g in gs:
            state, img = render_frame(renderer, g, state)
            out[name].append(img.cpu().numpy())
    return out


def _rank_entry(rank: int, n_ranks: int, store_path: str, backend: str,
                fn, args, results) -> None:
    """One rank process: join the group, put (rank, fn(rank, *args)) on
    `results`, leave the group. A failure puts (rank, traceback text) and
    exits with 1."""
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n_ranks), rank=rank,
            world_size=n_ranks)
        out = fn(rank, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, exit 1
        results.put((rank, traceback.format_exc()))
        sys.exit(1)


def spawn(fn, n_ranks: int, backend: str, args=(),
          timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run fn(rank, *args) in n_ranks processes (torch.multiprocessing,
    spawn) that form one process group of `backend` through a FileStore,
    and return the results in rank order. fn must be importable by name.
    Raises if a rank fails, exits without a result, or the ranks do not
    finish within `timeout` seconds; every rank process is stopped before
    it returns or raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, n_ranks, os.path.join(d, "store"),
                                   backend, fn, args, results), daemon=True)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_ranks)) - set(got))} did "
                        f"not finish within {timeout:.0f} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                try:
                    # a rank that has exited has flushed what it put
                    rank, out = results.get(
                        timeout=5.0 if dead else min(left, 1.0))
                except queue.Empty:
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if isinstance(out, str):
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    raise TimeoutError(f"rank process {p.pid} did not exit")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [got[r] for r in range(n_ranks)]


def render_rank(rank: int, job: Job) -> dict:
    """One rank of run_ranks: render the job's row tiles. Returns the
    tile (row0, rows), the device and, under "configs", per configuration
    the gathered images (rank 0 only), this rank's seconds per frame
    (synchronised, the halo exchanges included, the gather not), the halo
    telemetry and the kernel launches of its frames."""
    dev = _device(job, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # ranks sharing the host's cores split them
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // dist.get_world_size()))
    renderer = _renderer(job, dev)
    mesh = pm.make_mesh(job.backend)
    step = pm.make_sharded_render_fn(renderer, mesh)
    configs = {}
    for name, (cb, gs) in frame_plan(renderer, job).items():
        if not gs:
            continue
        state = pm.shard_frame_state(
            init_frame_state(job.width, job.height, cb, device=dev), mesh)
        images, seconds = [], []
        before = launches()
        for g in gs:
            _sync(dev)
            t0 = time.perf_counter()
            state, tile = step(g, state)
            _sync(dev)
            seconds.append(time.perf_counter() - t0)
            image = pm.gather_frame(tile, mesh)
            if rank == 0:
                images.append(image.cpu().numpy())
        after = launches()
        configs[name] = {
            "images": images, "seconds": seconds,
            "telemetry": dict(step.halo_telemetry),
            "launches": {k: after[k] - before[k] for k in COUNTED}}
    return {"row0": step.row0, "rows": step.h_local, "device": str(dev),
            "configs": configs}


def run_ranks(job: Job, n_ranks: int,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """render_rank on n_ranks rank processes (spawn)."""
    return spawn(render_rank, n_ranks, job.backend, (job,), timeout)


def parity(got: np.ndarray, want: np.ndarray) -> dict:
    """The two numbers of the JAX dry run's bar: the share of pixels equal
    in every channel and the mean |diff| over all values."""
    return {"bit_exact": float(np.mean(np.all(got == want, axis=-1))),
            "mean_abs_diff": float(np.mean(np.abs(got - want)))}


def check(stats: dict, what: str) -> None:
    """Raise unless the stats meet the JAX dry run's bar."""
    if not (stats["bit_exact"] > MIN_BIT_EXACT
            and stats["mean_abs_diff"] < MAX_MEAN_DIFF):
        raise AssertionError(
            f"{what}: the sharded frame diverged from the unsharded one: "
            f"bit-exact {stats['bit_exact']:.4f} (needs > {MIN_BIT_EXACT}), "
            f"mean |diff| {stats['mean_abs_diff']:.2e} (needs < "
            f"{MAX_MEAN_DIFF})")


def dryrun(n_ranks: int = 2, width: int = 64, height: int = 64,
           backend: str = "nccl", device: str = "cuda") -> dict:
    """Render the Cornell box's two dry-run configurations unsharded in
    this process and on n_ranks row tiles, hold every frame to the bar,
    and return {name: [parity per frame]} with the ranks' telemetry.
    Raises at once where device is cuda and no card is present."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; "
                           "pass --device cpu --backend gloo to run the "
                           "ranks on the CPU")
    with tempfile.TemporaryDirectory() as d:
        job = Job(glb=write_cornell(Path(d) / "cornell.glb"), width=width,
                  height=height, device=device, backend=backend)
        want = render_unsharded(job)
        ranks = run_ranks(job, n_ranks)
    report = {}
    for name, frames in want.items():
        got = ranks[0]["configs"][name]
        stats = [parity(img, ref) for img, ref in zip(got["images"], frames)]
        for f, s in enumerate(stats):
            check(s, f"{name} frame {f}")
        report[name] = {
            "parity": stats, "telemetry": got["telemetry"],
            "seconds": [r["configs"][name]["seconds"] for r in ranks]}
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="process group backend (default nccl: a card a "
                         "rank; gloo where ranks share a card or the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the ranks render on (default cuda; the "
                         "run fails without one rather than fall back)")
    a = ap.parse_args(argv)
    report = dryrun(a.ranks, a.width, a.height, a.backend, a.device)
    for name, r in report.items():
        for f, s in enumerate(r["parity"]):
            print(f"dryrun parity ({name} frame {f}): bit-exact "
                  f"{s['bit_exact']:.4f}, mean|diff| "
                  f"{s['mean_abs_diff']:.2e}")
        print(f"dryrun halo telemetry ({name}): {r['telemetry']}")


if __name__ == "__main__":
    main()
