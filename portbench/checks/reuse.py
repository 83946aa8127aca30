"""reuse: the four reuse stages of the window's last recorded frame held to
the plain reference (reference/resampling.py): GI temporal and spatial
resampling (render/frame.py's gi_temporal_pass and gi_spatial_pass) and
DI temporal and spatial resampling (render/di_passes.py's
di_temporal_resampling and di_spatial_resampling).

install() wraps those names where the program looks them up, and
render_frame (the state the frame starts from) and make_bridge (the
frame's G-buffer planes, the previous frame's, its GConst), and keeps
references, not copies, to what they take and return in the last window
frame outside the profiled ones. The previous frame's reservoirs the
temporal stages must read are taken from the state the frame starts
from, in the slots where the upstream's buffer indices put them
(light_passes.rs:621-660): the GI spatial output and the shaded DI
reservoirs; a stage that reads another slot is wrong.

evidence() draws spec["pixels"] foreground pixels from the seed and
gathers the stages' inputs and outputs there; the images the neighbours
come from (both G-buffers, the previous frame's reservoirs, this frame's
temporal outputs) stay whole, since the reference draws which neighbours
it reads. Each stage's source is the stage before it: GI spatial starts
from the program's GI temporal output, DI spatial from its DI temporal
output.

numbers(): per stage, the share of the pixels whose output reservoir
names another sample (GI: another position; DI: another light or uv) or
whose weight sum, M or age differs by more than REL of the larger
(<stage>_bad_share), and the pixels compared (<stage>_pixels); and
gi_temporal_reused_share, the share of the pixels where the reference's
GI temporal stage took the previous frame's sample.
"""

from __future__ import annotations

import torch

from portbench.check import CONTROL_DTYPE
from portbench.reference import resampling as rs

FRAME = "raytracer2_tpu_torch.render.frame"
DI = "raytracer2_tpu_torch.render.di_passes"
STAGES = ("gi_temporal", "gi_spatial", "di_temporal", "di_spatial")
# the goldens' relative tolerance; float32 rounding of the same sums and
# products stays far below it
REL = 2e-3
SALT = 0x2E05E
GI_T = "restir_gi.temporal_resampling_params."
GI_S = "restir_gi.spatial_resampling_params."
DI_T = "restir_di.temporal_resampling_params."
DI_S = "restir_di.spatial_resampling_params."
# settings the reference does not implement, and the value it needs
NEEDS = {GI_T + "temporal_bias_correction_mode": 2,
         GI_S + "spatial_bias_correction_mode": 2,
         DI_T + "temporal_bias_correction": 2,
         DI_S + "spatial_bias_correction": 2,
         GI_T + "enable_permutation_sampling": 0,
         DI_T + "enable_permutation_sampling": 0,
         GI_T + "enable_boiling_filter": 0,
         DI_T + "enable_boiling_filter": 0,
         DI_S + "discount_naive_samples": 0,
         GI_T + "uniform_random_number": 0,
         DI_T + "uniform_random_number": 0}


# the state's slots of the previous frame's GI spatial output and shaded
# DI reservoirs (GIBufferIndices, DIBufferIndices; main.rs:240-367)
GI_SPATIAL_SLOT = ("restir_gi.buffer_indices."
                   "spatial_resampling_output_buffer_index", 1)
DI_SHADED_SLOT = ("restir_di.buffer_indices.shading_input_buffer_index", 0)
# name -> (target, what to keep of a call)
TARGETS = {
    "state": (f"{FRAME}:render_frame", lambda a, k, out: a[2]),
    "bridge": (f"{FRAME}:make_bridge", lambda a, k, out: (a[2], a[3], a[4])),
    "gi_temporal": (f"{FRAME}:gi_temporal_pass",
                    lambda a, k, out: (a[2], a[3], a[4], out)),
    "gi_spatial": (f"{FRAME}:gi_spatial_pass",
                   lambda a, k, out: (a[2], out)),
    "di_temporal": (f"{DI}:di_temporal_resampling",
                    lambda a, k, out: (a[3], a[4], a[6], out[0])),
    "di_spatial": (f"{DI}:di_spatial_resampling",
                   lambda a, k, out: (a[3], a[4], a[6], out[0])),
}


def install(sampler, spec):
    run = sampler.run
    kept: dict[int, dict] = {}  # the last recorded frame's calls, by name
    sampler.reuse_frames = kept

    def keep(name, pick):
        def make(inner):
            def called(*args, **kwargs):
                out = inner(*args, **kwargs)
                k = run.frame
                if k >= 0 and not run.profiling:
                    if k not in kept:
                        kept.clear()
                        kept[k] = {}
                    kept[k][name] = pick(args, kwargs, out)
                return out
            return called
        return make

    for name, (target, pick) in TARGETS.items():
        run.wrap(target, keep(name, pick))


def _planes(gbuffer) -> rs.Planes:
    return rs.Planes(gbuffer.depth, gbuffer.normals, gbuffer.geo_normals,
                     gbuffer.diffuse_albedo, gbuffer.specular_rough)


def _gi(res) -> rs.GIRes:
    return rs.GIRes(res.position, res.normal, res.radiance, res.weight_sum,
                    res.m, res.age)


def _di(res) -> rs.DIRes:
    return rs.DIRes(res.light_data, res.uv_data, res.weight_sum,
                    res.target_pdf, res.m, res.age, res.canonical_weight)


def _at(res, x, y):
    return type(res)(*(f[y, x].clone() for f in res))


def evidence(sampler, state, prior, img, g_const, pose, frame, spec):
    kept = getattr(sampler, "reuse_frames", {})
    whole = [rec for rec in kept.values()
             if all(s in rec for s in STAGES + ("state", "bridge"))]
    if not whole:
        return {"recorded": False}
    rec = whole[0]
    gbuffer, prev_gbuffer, g = rec["bridge"]
    gi_in, _, gi_motion, gi_t_out = rec["gi_temporal"]
    _, gi_s_out = rec["gi_spatial"]
    di_in, di_rng, di_motion, di_t_out = rec["di_temporal"]
    _, s_rng, _, di_s_out = rec["di_spatial"]
    gconst = sampler.run.cell.mix["gconst"]
    gi_prev = rec["state"].gi_reservoirs[gconst.get(*GI_SPATIAL_SLOT)]
    di_prev = rec["state"].di_reservoirs[gconst.get(*DI_SHADED_SLOT)]

    h, w = gbuffer.depth.shape
    dev = gbuffer.depth.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((sampler.seed ^ SALT) & 0x7FFFFFFFFFFFFFFF)
    lin = torch.randint(0, w * h, (2 * spec["pixels"],), generator=gen,
                        device=dev)
    fg = gbuffer.depth.reshape(-1)[lin] != rs.BACKGROUND_DEPTH
    lin = lin[torch.nonzero(fg)[:, 0][:spec["pixels"]]]
    x, y = lin % w, lin // w

    def position(view):
        return tuple(float(v) for v in view.camera_direction_or_position[:3])

    return {
        "recorded": True, "x": x, "y": y, "frame": int(g.frame),
        "position": position(g.view),
        "prev_position": position(g.prev_view),
        "planes": _planes(gbuffer), "prev_planes": _planes(prev_gbuffer),
        "gi_motion": gi_motion[y, x].clone(),
        "di_motion": di_motion[y, x].clone(),
        "gi_in": _at(_gi(gi_in), x, y), "gi_prev": _gi(gi_prev),
        "gi_t_out": _gi(gi_t_out), "gi_s_out": _at(_gi(gi_s_out), x, y),
        "di_in": _at(_di(di_in), x, y), "di_prev": _di(di_prev),
        "di_seed": di_rng.seed[y, x].clone(),
        "di_index": di_rng.index[y, x].clone(),
        "di_t_out": _di(di_t_out),
        "s_seed": s_rng.seed[y, x].clone(),
        "s_index": s_rng.index[y, x].clone(),
        "di_s_out": _at(_di(di_s_out), x, y),
    }


def params(gconst: dict) -> tuple[rs.GIParams, rs.DIParams]:
    """The reference's parameters from a mix's GConst settings (a key it
    leaves out keeps the upstream's default); a setting the reference
    does not implement raises."""
    for key, need in NEEDS.items():
        if gconst.get(key, need) != need:
            raise ValueError(f"the reuse check needs {key} = {need}")
    for key in ("runtime_params.active_checkerboard_field", "environment"):
        if gconst.get(key, 0):
            raise ValueError(f"the reuse check needs {key} = 0")

    def pick(cls, keys):
        return cls(**{f: gconst[k] for f, k in keys.items() if k in gconst})

    gi = pick(rs.GIParams, {
        "max_history_length": GI_T + "max_history_length",
        "max_reservoir_age": GI_T + "max_reservoir_age",
        "temporal_depth_threshold": GI_T + "depth_threshold",
        "temporal_normal_threshold": GI_T + "normal_threshold",
        "enable_fallback_sampling": GI_T + "enable_fallback_sampling",
        "spatial_depth_threshold": GI_S + "spatial_depth_threshold",
        "spatial_normal_threshold": GI_S + "spatial_normal_threshold",
        "num_spatial_samples": GI_S + "num_spatial_samples",
        "spatial_sampling_radius": GI_S + "spatial_sampling_radius",
        "neighbor_offset_mask": "runtime_params.neighbor_offset_mask"})
    di = pick(rs.DIParams, {
        "max_history_length": DI_T + "max_history_length",
        "temporal_depth_threshold": DI_T + "temporal_depth_threshold",
        "temporal_normal_threshold": DI_T + "temporal_normal_threshold",
        "num_spatial_samples": DI_S + "num_spatial_samples",
        "num_disocclusion_boost_samples":
            DI_S + "num_disocclusion_boost_samples",
        "spatial_sampling_radius": DI_S + "spatial_sampling_radius",
        "spatial_depth_threshold": DI_S + "spatial_depth_threshold",
        "spatial_normal_threshold": DI_S + "spatial_normal_threshold",
        "neighbor_offset_mask": DI_S + "neighbor_offset_mask"})
    return gi, di


def _far(a, b):
    a, b = a.double(), b.double()
    return (a - b).abs() > REL * torch.maximum(a.abs(), b.abs())


def gi_bad(got: rs.GIRes, ref: rs.GIRes) -> torch.Tensor:
    """[n] bool: another sample, or a weight sum, M or age off by more
    than REL."""
    other = (got.position.float() != ref.position.float()).any(-1)
    return (other | _far(got.weight_sum, ref.weight_sum)
            | _far(got.m, ref.m) | _far(got.age, ref.age))


def di_bad(got: rs.DIRes, ref: rs.DIRes) -> torch.Tensor:
    other = ((got.light_data.long() != ref.light_data.long())
             | (got.uv_data.long() != ref.uv_data.long()))
    return (other | _far(got.weight_sum, ref.weight_sum)
            | _far(got.m, ref.m) | _far(got.age, ref.age))


def stages(ev: dict, scene, gi_p: rs.GIParams, di_p: rs.DIParams,
           dtype=torch.float32) -> dict:
    """Each stage's reference output at the evidence's pixels, and the
    GI temporal stage's reuse mask."""
    x, y = ev["x"], ev["y"]
    dev = x.device
    w, h = ev["width"], ev["height"]
    direction = tuple(ev["pose"]["direction"])
    cam = rs.Camera(ev["position"], direction, w, h)
    prev_cam = rs.Camera(ev["prev_position"], direction, w, h)
    lights = rs.stored_lights(scene, dev)
    offsets = rs.neighbor_offsets(device=dev)
    planes, prev_planes = ev["planes"], ev["prev_planes"]
    gi_t, reused = rs.gi_temporal(
        x, y, planes, cam, prev_planes, prev_cam, ev["gi_motion"],
        ev["frame"], ev["gi_in"], ev["gi_prev"], gi_p, dtype)
    gi_s = rs.gi_spatial(x, y, planes, cam, ev["frame"],
                         _at(ev["gi_t_out"], x, y), ev["gi_t_out"], gi_p,
                         offsets, dtype)
    di_t = rs.di_temporal(x, y, planes, cam, prev_planes, prev_cam,
                          ev["di_motion"], ev["di_seed"], ev["di_index"],
                          ev["di_in"], ev["di_prev"], lights, di_p, dtype)
    di_s = rs.di_spatial(x, y, planes, cam, ev["s_seed"], ev["s_index"],
                         _at(ev["di_t_out"], x, y), ev["di_t_out"], lights,
                         di_p, offsets, dtype)
    return {"gi_temporal": gi_t, "gi_spatial": gi_s, "di_temporal": di_t,
            "di_spatial": di_s, "reused": reused}


def numbers(ev, scene, spec, seed, control):
    r = ev["reuse"]
    if not r["recorded"]:
        out = {f"{s}_bad_share": 1.0 for s in STAGES}
        out.update({f"{s}_pixels": 0 for s in STAGES})
        out["gi_temporal_reused_share"] = 0.0
        return out
    gi_p, di_p = params(ev["mix"]["gconst"])
    r = dict(r, width=ev["width"], height=ev["height"], pose=ev["pose"])
    ref = stages(r, scene, gi_p, di_p)
    if control:
        got = stages(r, scene, gi_p, di_p, dtype=CONTROL_DTYPE)
    else:
        x, y = r["x"], r["y"]
        got = {"gi_temporal": _at(r["gi_t_out"], x, y),
               "gi_spatial": r["gi_s_out"],
               "di_temporal": _at(r["di_t_out"], x, y),
               "di_spatial": r["di_s_out"]}
    out = {}
    for s in STAGES:
        bad = (gi_bad if s.startswith("gi") else di_bad)(got[s], ref[s])
        out[f"{s}_bad_share"] = float(bad.float().mean()) if bad.numel() \
            else 1.0
        out[f"{s}_pixels"] = int(bad.numel())
    out["gi_temporal_reused_share"] = float(ref["reused"].float().mean()) \
        if ref["reused"].numel() else 0.0
    return out

