"""Application driver, port of raytracer2_tpu/app.py: the main.rs
equivalent as an offline/headless CLI.

    python -m raytracer2_tpu_torch.app [scene.glb] [--device cuda|cpu] ...

The reference's frame loop (src/main.rs:484-733) is a winit window + imgui
parameter editor; the capabilities that matter — scene load, per-frame GConst
mutation, camera fly-through, reservoir ping-pong, frame-budget telemetry —
are reproduced here as a headless driver that renders N frames along a camera
path and writes PNGs/metrics. Live parameter editing maps to CLI flags over
the same GConst surface.

Everything runs on --device (default cuda; the run fails rather than fall
back when no CUDA device is present). --backend takes the JAX app's
engines (bundle_pallas is the port's CUDA bundle walk, as auto) and the
port's bundle_cuda; the traversal knobs --cull, --group, --bundle-size,
--shadow-order, --sort-key and --cluster-size take the JAX app's choices
and go to make_tracers as the JAX app sends them. --k-cand sets every
ray class's candidate budget. Checkpoints use the JAX app's .npz layout,
so each app resumes from the other's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("raytracer2_tpu_torch")

FRAME_BUDGET_SECONDS = 0.016  # 16 ms budget (main.rs:653-656)


def build_arg_parser() -> argparse.ArgumentParser:
    from raytracer2_tpu_torch.render.app_bridge import BACKENDS, SHADOW_ORDERS

    p = argparse.ArgumentParser(
        description="ReSTIR path tracer on PyTorch/CUDA (RayTracer2 "
                    "rebuild)")
    p.add_argument("scene", nargs="?", default=None,
                   help=".glb/.gltf scene (default: procedural Cornell box)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu for "
                        "a run without a GPU)")
    p.add_argument("--skybox", default=None, help=".exr equirect environment")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default="out", help="output directory for PNGs")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--camera-pos", type=float, nargs=3, default=(0.0, 0.0, 10.0))
    p.add_argument("--camera-dir", type=float, nargs=3, default=(0.0, 0.0, 1.0))
    p.add_argument("--fov", type=float, default=65.0)
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera around the origin (fly-through)")
    # GConst surface (the imgui GConstEditor fields, main.rs:522-627).
    # NOTE: GConst itself keeps the reference's startup value
    # enable_restir_di=0 (main.rs:391) for parity; the CLI defaults DI ON
    # so the flagship demo command renders DI+GI with no extra flags.
    p.add_argument("--reference-mode", action="store_true")
    p.add_argument("--enable-restir-di", type=int, default=1)
    p.add_argument("--enable-restir-gi", type=int, default=1)
    p.add_argument("--enable-temporal-resampling", type=int, default=0)
    p.add_argument("--enable-spatial-resampling", type=int, default=0)
    p.add_argument("--di-resampling", default="off",
                   choices=["off", "temporal", "spatial", "spatiotemporal"],
                   help="DI reservoir reuse in the fused pass; 'off' is "
                        "the reference quirk (the spatio-temporal call is "
                        "commented out, di_fused_resampling.rgen:69-70)")
    p.add_argument("--enable-accumulation", type=int, default=0)
    p.add_argument("--blend-factor", type=float, default=None,
                   help="accumulation blend; default auto-computes 1/N "
                        "while accumulating (main.rs:629-635)")
    p.add_argument("--environment", type=int, default=None,
                   help="1 to enable the environment light (auto if --skybox)")
    p.add_argument("--textures", type=int, default=1)
    p.add_argument("--no-bvh", action="store_true",
                   help="brute-force intersection (oracle mode; the same "
                        "as --backend brute)")
    p.add_argument("--backend", default="auto", choices=BACKENDS,
                   help="ray traversal engine (auto, bundle_pallas: the "
                        "bundle walk; bundle, scatter: the XLA engines' "
                        "ports)")
    # light-sampling subsystems (frame-1 presample dispatch analogues,
    # light_passes.rs:538-547; ReGIR grid = local_light_sampling_mode 2)
    p.add_argument("--presample", type=int, default=1,
                   help="fill the RIS presample tiles at scene load")
    p.add_argument("--regir", action="store_true",
                   help="build the ReGIR world-space light grid (enables "
                        "local_light_sampling_mode=2)")
    p.add_argument("--local-light-sampling-mode", type=int, default=None,
                   choices=[0, 1, 2],
                   help="0 uniform, 1 power-RIS, 2 ReGIR (needs --regir)")
    # traversal tuning (ops/cuda_traverse.py knobs, the JAX app's choices)
    p.add_argument("--cull", default=None,
                   choices=["auto", "exact", "exact_iv", "interval", "hier"],
                   help="bundle culling strategy (default: auto)")
    p.add_argument("--k-cand", type=int, default=None,
                   help="max ranked candidate clusters per bundle, for "
                        "every ray class (default: sized per class by "
                        "the k_cand probe)")
    p.add_argument("--group", type=int, default=None,
                   help="clusters intersected per walk step")
    p.add_argument("--bundle-size", type=int, default=None,
                   help="rays per traversal bundle")
    p.add_argument("--shadow-order", default=None,
                   choices=list(SHADOW_ORDERS),
                   help="visibility-batch ray ordering: pixz = static "
                        "pixel-Z presort (no runtime sort), octz = "
                        "octant|t-bucket cheap re-sort, cand0 = full "
                        "nearest-cluster sort")
    p.add_argument("--sort-key", default=None,
                   choices=["cand0", "hier", "octz"],
                   help="cull-order ray sort key (exact cull, unsorted "
                        "batches): cand0 = dense nearest-cluster, hier = "
                        "supercluster-refined (~1/32 the key cost)")
    p.add_argument("--cluster-size", type=int, default=None,
                   help="triangles per cluster (acceleration build)")
    p.add_argument("--checkerboard", action="store_true",
                   help="checkerboard rendering: lighting passes trace "
                        "half the pixel grid per frame, alternating "
                        "fields (RtxdiHelpers.hlsli:16-61)")
    p.add_argument("--interactive", action="store_true",
                   help="live terminal session (main.rs:484-733 analogue): "
                        "frames render continuously as truecolor half-block "
                        "cells; WASD+QE fly, IJKL look, number keys toggle "
                        "the GConstEditor fields live")
    p.add_argument("--animate", default=None,
                   help="JSON file of per-frame GConst overrides: "
                        '{"<frame>": {"field": value, ...}, ...} — the '
                        "offline analogue of the imgui GConstEditor's "
                        "live parameter edits (main.rs:522-627)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of the frames "
                        "into this directory, with the program's spans "
                        "(rt2:pass.*, rt2:trace.*, rt2:readback.*) on; "
                        "their times and counts go to spans.json there")
    p.add_argument("--checkpoint", default=None,
                   help="save final frame state to this .npz for resume")
    p.add_argument("--resume", default=None,
                   help="load frame state from a .npz checkpoint")
    return p


def load_scene(args, device: torch.device):
    from raytracer2_tpu_torch.scene import gltf
    from raytracer2_tpu_torch.scene.scene import build_scene

    skybox = None
    if args.skybox:
        from raytracer2_tpu_torch.scene.exr import load_exr

        skybox = load_exr(args.skybox)
        logger.info("skybox %s: %sx%s", args.skybox,
                    skybox.shape[1], skybox.shape[0])

    if args.scene:
        model = gltf.load_file(args.scene)
        logger.info("model loaded: %d vertices, %d indices, %d nodes",
                    model.positions.shape[0], model.indices.shape[0],
                    len(model.nodes))
    else:
        from raytracer2_tpu_torch.models import procedural as proc

        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "cornell.glb"
            proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
            model = gltf.load_file(p)
        logger.info("procedural Cornell box loaded")
    return build_scene(model, skybox=skybox, device=device)


def _flatten(state) -> list:
    """The state's tensors in the order JAX's tree_flatten walks the
    FrameState pytree: NamedTuple fields and tuple items in order, depth
    first."""
    if torch.is_tensor(state):
        return [state]
    return [leaf for item in state for leaf in _flatten(item)]


def _unflatten(template, leaves):
    """template with its tensors replaced by `leaves` (an iterator), in
    _flatten's order."""
    if torch.is_tensor(template):
        return next(leaves)
    items = [_unflatten(item, leaves) for item in template]
    return (type(template)(*items) if hasattr(template, "_fields")
            else tuple(items))


def save_checkpoint(path: str, state, frame: int) -> None:
    """Serialize the frame state (reservoirs, G-buffers, lighting) — the
    cross-frame persistent state the reference can't save (SURVEY.md §5) —
    as the JAX app's .npz: `frame`, `treedef` and `leaf_{i}` in tree_flatten
    order, the int64 tensors that carry uint32 values as uint32."""
    arrays = {}
    for i, leaf in enumerate(_flatten(state)):
        a = leaf.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = a.astype(np.uint32) if a.dtype == np.int64 else a
    np.savez_compressed(path, frame=frame,
                        treedef=f"{type(state).__name__}, "
                                f"{len(arrays)} leaves",
                        **arrays)


def load_checkpoint(path: str, template):
    """(state shaped and typed as `template`, frame) from a checkpoint of
    either app."""
    data = np.load(path, allow_pickle=False)
    leaves = _flatten(template)
    restored = []
    for i, leaf in enumerate(leaves):
        a = data[f"leaf_{i}"]
        if a.shape != tuple(leaf.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {a.shape}, the "
                             f"frame state {tuple(leaf.shape)}")
        if a.dtype == np.uint32:  # the port carries uint32 in int64
            a = a.astype(np.int64)
        restored.append(torch.from_numpy(np.ascontiguousarray(a)).to(
            device=leaf.device, dtype=leaf.dtype))
    return _unflatten(template, iter(restored)), int(data["frame"])


def _traversal_overflow(renderer, view, width: int, height: int
                        ) -> bool | None:
    """Traversal-truncation telemetry (VERDICT r2 #4): with this camera's
    primary rays and with the same rays in default_rng(0) normal
    directions, whether some bundle's candidate union exceeds the bounce
    class's k_cand (the class the JAX app's probe traces them as). True
    means the overflow fallback re-traced bundles; None for a backend
    without union_max."""
    tracers = renderer.tracers
    if tracers.union_max is None:
        return None
    from raytracer2_tpu_torch.render import rays as raysmod

    dev = renderer.scene.device
    px, py = raysmod.pixel_grid(width, height, device=dev)
    rays = raysmod.setup_primary_ray(px.reshape(-1), py.reshape(-1), view)
    rng = np.random.default_rng(0)
    d_inc = rng.normal(size=(rays.direction.shape[0], 3))
    d_inc /= np.linalg.norm(d_inc, axis=-1, keepdims=True)
    d_inc = torch.from_numpy(d_inc.astype(np.float32)).to(dev)
    k = tracers.k_cand_by_class[False]
    return any(int(tracers.union_max(rays.origin, d, rays.t_min,
                                     rays.t_max)) > k
               for d in (rays.direction, d_inc))


def tracer_options(args) -> dict:
    """The traversal knobs the app passes to make_tracers (the JAX app's
    tracer_opts, but for --k-cand: the k_cand_per_class of every class)."""
    return {k: v for k, v in dict(
        cull=args.cull, group=args.group, bundle_size=args.bundle_size,
        sort_key=args.sort_key, shadow_order=args.shadow_order,
        cluster_size=args.cluster_size).items() if v is not None}


def _size_k_cand(renderer, scene, args, view):
    """Auto-size the traversal candidate budgets for this scene and
    camera (VERDICT r4 #4): zero-truncation k_cand per ray class, with the
    bounded overflow fallback still on as the safety net. Returns the
    renderer, its tracers rebuilt (with the app's other knobs) where a
    budget changed."""
    from raytracer2_tpu_torch.render.app_bridge import (
        make_tracers, suggest_k_cand)

    sug = suggest_k_cand(renderer, view=view)
    if not sug:
        return renderer
    logger.info("zero-truncation k_cand per class: %s "
                "(pixel-tile truncation stays covered by the "
                "exact bounded fallback — cheaper than ranking "
                "full lists for sky/grazing bundles)",
                {str(k): v for k, v in sug.items()})
    cur = renderer.tracers.k_cand_by_class or {}
    apply = {k: v for k, v in sug.items()
             if k is not True and v != cur.get(k)}
    if not apply:
        return renderer
    return dataclasses.replace(renderer, tracers=make_tracers(
        scene, use_bvh=not args.no_bvh, backend=args.backend,
        k_cand_per_class=apply, **tracer_options(args)))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_arg_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device "
                           "(torch.cuda.is_available() is false); pass "
                           "--device cpu to render on the CPU")

    # the build cache (JAX's compile cache): the kernels and the cluster
    # builder compile at first use into build/ of a writable checkout, or
    # a user-level cache for an installed package
    from raytracer2_tpu_torch.compile_cache import enable_compile_cache
    enable_compile_cache()
    from raytracer2_tpu_torch.params import default_gconst
    from raytracer2_tpu_torch.render.frame import (
        create_renderer, init_frame_state, render_frame)
    from raytracer2_tpu_torch.render.postprocess import to_srgb_u8
    from raytracer2_tpu_torch.scene.camera import default_camera
    from raytracer2_tpu_torch.utils.png import write_png
    from raytracer2_tpu_torch.utils import profiler
    from raytracer2_tpu_torch.utils.profiler import (
        PassTimer, count_frame_rays)

    scene = load_scene(args, dev)
    logger.info("scene: %d triangles, %d geometries, %d emissive",
                scene.num_triangles, scene.num_geometries,
                scene.num_emissive_triangles)

    k_cand = (None if args.k_cand is None else
              {True: args.k_cand, False: args.k_cand, "shadow": args.k_cand})
    renderer = create_renderer(scene, args.width, args.height,
                               use_bvh=not args.no_bvh, backend=args.backend,
                               presample=bool(args.presample),
                               regir=args.regir,
                               tracer_opts=tracer_options(args),
                               k_cand_per_class=k_cand)
    camera = default_camera(
        window_size=(args.width, args.height),
        position=tuple(args.camera_pos), direction=tuple(args.camera_dir),
        fov=args.fov)
    if args.k_cand is None:
        renderer = _size_k_cand(renderer, scene, args,
                                camera.planar_view_constants())

    environment = args.environment
    if environment is None:
        environment = 1 if args.skybox else 0

    g_const = default_gconst(
        camera.planar_view_constants(),
        renderer.scene_lights.num_local_lights,
        refrence_mode=1 if args.reference_mode else 0,
        enable_restir_di=args.enable_restir_di,
        enable_restir_gi=args.enable_restir_gi,
        enable_temporal_resampling=args.enable_temporal_resampling,
        enable_spatial_resampling=args.enable_spatial_resampling,
        enable_accumulation=args.enable_accumulation,
        textures=args.textures,
        environment=environment,
        blend_factor=float(np.float32(
            0.1 if args.blend_factor is None else args.blend_factor)),
        enable_di_resampling={"off": 0, "temporal": 1, "spatial": 2,
                              "spatiotemporal": 3}[args.di_resampling],
    )

    if args.local_light_sampling_mode is not None:
        isp = dataclasses.replace(
            g_const.restir_di.initial_sampling_params,
            local_light_sampling_mode=args.local_light_sampling_mode)
        g_const = g_const.replace(restir_di=dataclasses.replace(
            g_const.restir_di, initial_sampling_params=isp))

    state = init_frame_state(args.width, args.height,
                             checkerboard=args.checkerboard, device=dev)
    start_frame = 0
    if args.resume:
        state, start_frame = load_checkpoint(args.resume, state)
        logger.info("resumed from %s at frame %d", args.resume, start_frame)

    def step(g, s):
        return render_frame(renderer, g, s)

    def to_display(image):
        return to_srgb_u8(image).cpu().numpy()

    if args.interactive:
        from raytracer2_tpu_torch.viewer import run_interactive

        run_interactive(step, camera, g_const, state, to_display)
        return 0

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    timer = PassTimer(dev)

    # live GConst mutation (imgui GConstEditor analogue, main.rs:522-627):
    # overrides apply at their frame and persist
    animate = {}
    if args.animate:
        raw = json.loads(Path(args.animate).read_text())
        animate = {int(k): v for k, v in raw.items()}

    prev_view = g_const.view
    frame_times = []
    with contextlib.ExitStack() as profiling:
        if args.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = profiling.enter_context(
                torch.profiler.profile(activities=activities))
            spans = PassTimer(dev)
            profiler.enable(spans)
            profiling.callback(profiler.disable)
        for f in range(start_frame, start_frame + args.frames):
            if args.orbit:
                angle = 2.0 * np.pi * (f / max(args.frames, 1)) * 0.25
                r = float(np.linalg.norm(np.asarray(args.camera_pos)))
                pos = (r * np.sin(angle), args.camera_pos[1],
                       -r * np.cos(angle))
                camera = default_camera(
                    window_size=(args.width, args.height), position=pos,
                    direction=tuple(-np.asarray(pos) / max(r, 1e-6)),
                    fov=args.fov)
            if f in animate:
                g_const = g_const.replace(**animate[f])
                logger.info("frame %d: applied overrides %s", f, animate[f])
            view = camera.planar_view_constants()
            g = g_const.replace(view=view, prev_view=prev_view, frame=f)
            if args.blend_factor is None and args.enable_accumulation:
                # auto 1/N while accumulating, exactly like the reference
                # (main.rs:629-635: blend_factor = 1 / frames_accumulated)
                g = g.replace(blend_factor=float(np.float32(
                    1.0 / (f - start_frame + 1))))
            if args.checkerboard:
                g = g.replace(runtime_params=dataclasses.replace(
                    g.runtime_params, active_checkerboard_field=1 + (f & 1)))
            prev_view = view

            with timer.time("frame"):
                state, image = step(g, state)
            dt = timer.samples["frame"][-1]
            timer.count("rays", count_frame_rays(g, args.width, args.height))
            frame_times.append(dt)
            if dt > FRAME_BUDGET_SECONDS and f > start_frame:
                logger.error("Over Frame Budget!!!! %.1f ms", dt * 1000)
            logger.info("frame %d: %.1f ms (%.1f fps)", f, dt * 1000,
                        1.0 / max(dt, 1e-9))

            if (f - start_frame) % args.save_every == 0:
                write_png(out_dir / f"frame_{f:04d}.png", to_display(image))

    if args.profile:
        trace = Path(args.profile) / "trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        (trace.parent / "spans.json").write_text(spans.report())
        logger.info("profiler trace and spans.json written to %s",
                    trace.parent)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, start_frame + args.frames)
        logger.info("checkpoint written to %s", args.checkpoint)

    overflow = _traversal_overflow(renderer, g_const.view, args.width,
                                   args.height)
    if overflow:
        logger.warning(
            "traversal candidate truncation overflowed — the overflow "
            "fallback re-traced those bundles; raise --k-cand")

    steady = frame_times[1:] or frame_times
    metrics = {
        "traversal_overflow": overflow,
        "frames": len(frame_times),
        "p50_ms": round(float(np.percentile(steady, 50)) * 1000, 2),
        "mean_ms": round(float(np.mean(steady)) * 1000, 2),
        "fps": round(1.0 / max(float(np.percentile(steady, 50)), 1e-9), 2),
        # PassTimer telemetry: p50/p95 + rays/s (strictly more than the
        # reference's FPS overlay, SURVEY.md par.5)
        "telemetry": timer.summary(),
    }
    logger.info("metrics: %s", json.dumps(metrics))
    (out_dir / "metrics.json").write_text(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
