"""What decides a run's `correct`: the program's outputs from the window,
held to the plain reference (reference/), each compared number against
its limit in limits/<cell>.json.

During the window a Sampler keeps, from every trace call outside the
profiled frames, `per_call` rays drawn from the seed with the program's
answers. After the window it gathers the last frame's outputs at pixels
drawn from the seed. The
checks a mix names (its "checks" object) then compare:

- trace: closest hits of sampled live rays against brute force over every
  triangle (a hit or a miss that differs, or a t that differs by more than
  T_REL of the reference's); every window frame must have traced;
- occluded: the any-hit answers of sampled visibility rays against brute
  force;
- gbuffer: the last frame's G-buffer at sampled pixels (depth, normal,
  albedo, specular F0, roughness, emission) against the camera ray traced
  by brute force and the surface there, each within its packing format's
  rounding;
- post: the displayed pixels against the display transform of the last
  frame's lighting and G-buffer planes (the reference reads the program's
  lighting: it follows the program from its own state here);
- radiance: the reference mode's radiance at sampled pixels against a
  plain path tracer with the same random numbers;
- di: the last frame's direct light at sampled pixels, where the mix has
  DI on and GI off (so the lighting planes hold DI alone): the frame's
  own contribution, recovered from its lighting planes and the ones it
  started from, against the reference's shading of the light sample that
  the frame's shaded reservoir names (light, uv, inverse pdf) on the
  frame's G-buffer surface. The reference follows the program's state
  here: it takes the chosen sample and its weight from the reservoir;
- di_energy: what the light sampling does by itself. The accumulated
  lighting (a running mean over every frame since the first warm-up
  frame) against the plain many-light estimate of the same pixels: the
  relative error of the total, times the square root of the frames
  accumulated, so that its noise does not shrink with a longer window
  while a bias grows with it.

control=True puts the reference, computed in bfloat16, in the program's
place: the limits' upper readings.

A check that CHECKS does not hold is the module checks/<name>.py, found
by the name the mix gives it (as harness.load_reader finds
metrics/<name>.py), so a new check is a new file. It gives:

- numbers(ev, scene, spec, seed, control) -> dict (required): its
  compared numbers, by name, as the functions in CHECKS do; spec is its
  entry in the mix's "checks", scene the reference's (reference.glb);
- install(sampler, spec) (optional): called from Sampler.install once the
  renderer exists, before the warm-up. It observes or wraps the program's
  functions through sampler.run.observe and sampler.run.wrap, and, as
  the trace sample does, keeps nothing of the profiled frames
  (sampler.run.profiling);
- evidence(sampler, state, prior, img, g_const, pose, frame, spec) -> dict
  (optional): called from Sampler.evidence after the window, before the
  program's state is freed, with Sampler.evidence's arguments. It returns
  tensors gathered small, which numbers() finds as ev[<name>].
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch

from portbench.reference import agx, camera, lighting, pathtrace, surface
from portbench.reference import packing as pk
from portbench.reference.glb import load_glb
from portbench.reference.intersect import any_hit, closest_hit

BACKGROUND_DEPTH = 100000.0
CONTROL_DTYPE = torch.bfloat16
# a hit whose t agrees within this share of the reference's is the same
# surface: float32 rounding of the two intersection tests, or a tie
# between triangles that share the point
T_REL = 1e-4
# the G-buffer's packing formats (render_resources.rs:39-101): a 2x16
# unorm octahedral normal (a step of 2/65534), R11G11B10 unorm albedo
# (half a 10-bit step is 4.9e-4), RGBA8 gamma-2.2 F0 and roughness (half
# an 8-bit step, times the curve's slope of at most 2.2), float32 emission
NORMAL_TOL = 1e-3
ALBEDO_TOL = 1e-3
RGBA8_TOL = 5e-3
EMISSION_REL = 1e-5
# radiance of one pixel: float32 rounding along five bounces stays far
# below this; a path that took another way differs by its whole share
RADIANCE_REL, RADIANCE_ABS = 1e-3, 1e-5
# the frame's DI contribution against the reference's shading of its
# sample: the geometry's float32 rounding (the light record's packed
# edges, the surface rebuilt from its depth) stays below this share, and
# a contribution under DI_ABS is a grazing cosine's rounding (a light in
# the surface's own plane; lit pixels of the cells read 4e-4 and more)
DI_REL, DI_ABS = 2e-3, 1e-6
SEED_SALT = 0x5EED
# the benchmark's own device work in the window carries a profiler
# annotation of this prefix; the readers leave its kernels out
OWN_PREFIX = "portbench-own:"


class Sampler:
    """Keeps the window's trace answers on a sample drawn from the seed,
    and gathers the last frame's outputs after it. Sampling is the
    benchmark's own device work: it carries an OWN_PREFIX annotation and
    stays out of the profiled frames."""

    def __init__(self, run, checks: dict, seed: int):
        self.run, self.checks, self.seed = run, checks, seed
        self.closest, self.occluded = [], []
        self.traced: set[int] = set()  # window frames that traced
        self.gen = None

    def _pick(self, n: int, k: int, device):
        if self.gen is None:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(self.seed & 0x7FFFFFFFFFFFFFFF)
        return torch.randint(0, n, (k,), generator=self.gen, device=device)

    def _keep(self, store: list, per: int, rays, answers) -> None:
        run = self.run
        if run.frame < 0:
            return
        self.traced.add(run.frame)
        o = rays[0]
        if run.profiling or o.shape[0] == 0:
            return
        with torch.profiler.record_function(OWN_PREFIX + "sample"):
            i = self._pick(o.shape[0], per, o.device)
            store.append((run.frame, *(x[i] for x in rays + answers)))

    def install(self) -> None:
        per = self.checks.get("trace", {}).get("per_call", 0)
        per_vis = self.checks.get("occluded", {}).get("per_call", 0)
        sampler = self

        def closest(inner):
            def traced(o, d, tn, tx, *args, **kwargs):
                rec = inner(o, d, tn, tx, *args, **kwargs)
                sampler._keep(sampler.closest, per, (o, d, tn, tx),
                              (rec.t, rec.missed))
                return rec
            return traced

        def occluded(inner):
            def traced(o, d, tn, tx, *args, **kwargs):
                blocked = inner(o, d, tn, tx, *args, **kwargs)
                sampler._keep(sampler.occluded, per_vis, (o, d, tn, tx),
                              (blocked,))
                return blocked
            return traced

        if per:
            self.run.wrap("tracers:closest_hit", closest)
        if per_vis:
            self.run.wrap("tracers:occluded", occluded)
        for name, mod in self._found("install"):
            mod.install(self, self.checks[name])

    def _found(self, hook: str):
        """(name, module) of each of the mix's checks that CHECKS does not
        hold and whose module gives `hook`."""
        for name in self.checks:
            if name not in CHECKS:
                mod = load_check(name)
                if hasattr(mod, hook):
                    yield name, mod

    def _pixels(self, n: int, width: int, height: int, device, salt: int = 0):
        g = torch.Generator(device=device)
        g.manual_seed((self.seed ^ SEED_SALT ^ (salt << 16))
                      & 0x7FFFFFFFFFFFFFFF)
        lin = torch.randint(0, width * height, (n,), generator=g,
                            device=device)
        return lin % width, lin // width

    def evidence(self, state, prior, img, g_const, pose, frame: int) -> dict:
        """The program's outputs that the checks read, gathered small so
        that the program's state can be freed before the reference runs.
        prior: the lighting planes (diffuse, specular) the last frame
        started from; g_const: the last frame's GConst."""
        conf = self.run.cell.config
        w, h = conf["width"], conf["height"]
        dev = img.device
        ev = {"pose": pose, "frame": frame, "width": w, "height": h,
              "frames": self.run.frames, "traced": len(self.traced),
              "accumulated": self.run.accumulated, "mix": self.run.cell.mix,
              "seed": self.seed}

        def stack(rows, names):
            cols = list(zip(*rows))
            frame = torch.cat([torch.full((x.shape[0],), f, device=dev)
                               for f, x in zip(cols[0], cols[1])])
            return dict(frame=frame, **{k: torch.cat(c) for k, c in
                                        zip(names, cols[1:])})

        if self.closest:
            c = stack(self.closest, ("o", "d", "tn", "tx", "t", "missed"))
            c["hit"] = ~c.pop("missed")
            ev["closest"] = c
        if self.occluded:
            ev["occluded"] = stack(self.occluded,
                                   ("o", "d", "tn", "tx", "blocked"))
        gb = state.gbuffer

        def planes(px, py):
            return dict(px=px, py=py, depth=gb.depth[py, px].clone(),
                        normals=gb.normals[py, px].clone(),
                        albedo=gb.diffuse_albedo[py, px].clone(),
                        spec_rough=gb.specular_rough[py, px].clone(),
                        emissive=gb.emissive[py, px].clone())

        if "gbuffer" in self.checks:
            ev["gbuffer"] = planes(*self._pixels(
                self.checks["gbuffer"]["pixels"], w, h, dev))
        if "post" in self.checks:
            px, py = self._pixels(self.checks["post"]["pixels"], w, h, dev)
            ev["post"] = dict(
                planes(px, py), display=img[py, px].clone(),
                diffuse=state.diffuse_lighting[py, px].clone(),
                specular=state.specular_lighting[py, px].clone())
        if "radiance" in self.checks:
            px, py = self._pixels(self.checks["radiance"]["pixels"], w, h,
                                  dev)
            ev["radiance"] = dict(px=px, py=py, value=state.diffuse_lighting[
                py, px].clone())
        if "di" in self.checks or "di_energy" in self.checks:
            n = max(self.checks.get(k, {}).get("pixels", 0)
                    for k in ("di", "di_energy"))
            px, py = self._pixels(n, w, h, dev, salt=1)
            di = g_const.restir_di
            res = state.di_reservoirs[
                di.buffer_indices.shading_input_buffer_index]
            ev["di"] = dict(
                planes(px, py),
                diffuse=state.diffuse_lighting[py, px].clone(),
                specular=state.specular_lighting[py, px].clone(),
                prior_diffuse=prior[0][py, px].clone(),
                prior_specular=prior[1][py, px].clone(),
                light_data=res.light_data[py, px].clone(),
                uv_data=res.uv_data[py, px].clone(),
                weight=res.weight_sum[py, px].clone(),
                blend=float(g_const.blend_factor),
                final_visibility=bool(
                    di.shading_params.enable_final_visibility))
        for name, mod in self._found("evidence"):
            ev[name] = mod.evidence(self, state, prior, img, g_const, pose,
                                    frame, self.checks[name])
        return ev


def _subsample(n: int, k: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((seed ^ (SEED_SALT << 8)) & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(n, generator=g, device=device)[:k]


def _used(c: dict, scene) -> torch.Tensor:
    """Indices of the sampled rays whose answer a frame can use: live (t_max
    above t_min) and starting near the scene (inside its bounding box grown
    by its diagonal on every side, where the camera and every surface
    lie). The frame also traces rays from its background pixels, from a
    point BACKGROUND_DEPTH along the camera ray, and discards what they
    return."""
    corners = torch.cat([scene.v0, scene.v0 + scene.e1, scene.v0 + scene.e2])
    lo, hi = corners.min(0).values, corners.max(0).values
    grow = (hi - lo).norm()
    near = ((c["o"] >= lo - grow) & (c["o"] <= hi + grow)).all(-1)
    live = (c["tx"] > c["tn"]) & torch.isfinite(c["tx"])
    return torch.nonzero(live & near)[:, 0]


def _trace(ev, scene, spec, seed, control) -> dict:
    c = ev["closest"]
    live = _used(c, scene)
    pick = live[_subsample(live.shape[0], spec["rays"], seed, live.device)]
    o, d, tn, tx = c["o"][pick], c["d"][pick], c["tn"][pick], c["tx"][pick]
    t_ref, tri, _, _ = closest_hit(scene, o, d, tn, tx)
    hit_ref = tri >= 0
    if control:
        t_got, tri_got, _, _ = closest_hit(scene, o, d, tn, tx, CONTROL_DTYPE)
        hit_got = tri_got >= 0
    else:
        t_got, hit_got = c["t"][pick], c["hit"][pick]
    bad = (hit_got != hit_ref) | (hit_got & hit_ref & (
        (t_got - t_ref).abs() > T_REL * t_ref.abs()))
    return {"trace_bad_share": float(bad.float().mean()),
            "trace_rays": int(pick.numel()),
            "frames_untraced": int(ev["frames"] - ev["traced"])}


def _occluded(ev, scene, spec, seed, control) -> dict:
    c = ev["occluded"]
    live = _used(c, scene)
    pick = live[_subsample(live.shape[0], spec["rays"], seed + 1,
                           live.device)]
    args = (c["o"][pick], c["d"][pick], c["tn"][pick], c["tx"][pick])
    ref = any_hit(scene, *args)
    got = any_hit(scene, *args, CONTROL_DTYPE) if control \
        else c["blocked"][pick]
    return {"occluded_bad_share": float((got != ref).float().mean()),
            "occluded_rays": int(pick.numel())}


def _gbuffer_surface(scene, ev, dtype):
    g = ev["gbuffer"]
    o, d = camera.primary_rays(g["px"], g["py"], ev["pose"]["position"],
                               ev["pose"]["direction"], ev["width"],
                               ev["height"], dtype)
    n = o.shape[0]
    zeros = torch.zeros(n, device=o.device)
    t, tri, u, v = closest_hit(scene, o, d, zeros,
                               torch.full_like(zeros, BACKGROUND_DEPTH), dtype)
    s = surface.at_hit(scene, tri, u, v, dtype)
    f = {k: x.float() for k, x in s._asdict().items()}
    f["hit"] = tri >= 0
    f["depth"] = torch.where(f["hit"], t, BACKGROUND_DEPTH)
    return f


def _gbuffer(ev, scene, spec, seed, control) -> dict:
    ref = _gbuffer_surface(scene, ev, torch.float32)
    if control:
        got = _gbuffer_surface(scene, ev, CONTROL_DTYPE)
    else:
        g = ev["gbuffer"]
        sr = pk.rgba8_gamma(g["spec_rough"])
        got = {"depth": g["depth"], "hit": g["depth"] != BACKGROUND_DEPTH,
               "normal": pk.octahedral_normal(g["normals"]),
               "albedo": pk.r11g11b10(g["albedo"]), "specular_f0": sr[:, :3],
               "roughness": sr[:, 3], "emission": g["emissive"]}

    def far(key, tol):
        return ((got[key] - ref[key]).abs().reshape(got[key].shape[0], -1)
                > tol).any(-1)

    both = got["hit"] & ref["hit"]
    em_tol = EMISSION_REL * torch.clamp_min(ref["emission"].abs(), 1.0)
    wrong = ((got["depth"] - ref["depth"]).abs() > T_REL * ref["depth"].abs()) \
        | far("normal", NORMAL_TOL) | far("albedo", ALBEDO_TOL) \
        | far("specular_f0", RGBA8_TOL) | far("roughness", RGBA8_TOL) \
        | ((got["emission"] - ref["emission"]).abs() > em_tol).any(-1)
    bad = (got["hit"] != ref["hit"]) | (both & wrong)
    return {"gbuffer_bad_share": float(bad.float().mean()),
            "gbuffer_pixels": int(bad.numel())}


def _post(ev, scene, spec, seed, control) -> dict:
    p = ev["post"]
    g = ev["mix"]["gconst"]
    if g.get("environment", 0):
        raise ValueError("the post check has no environment map")
    if g.get("refrence_mode", 0):
        col = p["diffuse"]
    else:
        lit, spec_l = p["diffuse"], p["specular"]
        if g.get("textures", 1):
            lit = lit * pk.r11g11b10(p["albedo"])
            spec_l = spec_l * torch.clamp_min(
                pk.rgba8_gamma(p["spec_rough"])[:, :3], 0.01)
        fg = (p["depth"] != BACKGROUND_DEPTH)[:, None]
        col = torch.where(fg, lit + spec_l + p["emissive"], 0.0)
    ref = agx.tonemap(col)
    got = agx.tonemap(col, CONTROL_DTYPE) if control else p["display"]
    return {"post_max_err": float((got - ref).abs().max())}


def _radiance(ev, scene, spec, seed, control) -> dict:
    r = ev["radiance"]
    args = (scene, r["px"], r["py"], ev["pose"], ev["width"], ev["height"],
            ev["frame"], spec["samples"], spec["bounces"])
    ref = pathtrace.radiance(*args)
    got = pathtrace.radiance(*args, dtype=CONTROL_DTYPE) if control \
        else r["value"]
    bad = ((got - ref).abs() > RADIANCE_REL * ref.abs() + RADIANCE_ABS
           ).any(-1)
    return {"radiance_bad_share": float(bad.float().mean()),
            "radiance_pixels": int(bad.numel())}


def _shading(ev: dict, d: dict) -> lighting.Shading:
    """The surfaces the frame shaded: its G-buffer planes at the pixels,
    the position rebuilt from the depth along the camera ray."""
    pose = ev["pose"]
    o, ray = camera.primary_rays(d["px"], d["py"], pose["position"],
                                 pose["direction"], ev["width"], ev["height"])
    pos = o + ray * d["depth"][:, None]
    view = torch.as_tensor(pose["position"], dtype=torch.float32,
                           device=pos.device) - pos
    view = view / torch.sqrt((view * view).sum(-1, keepdim=True))
    sr = pk.rgba8_gamma(d["spec_rough"])
    return lighting.Shading(pos=pos, normal=pk.octahedral_normal(d["normals"]),
                            view=view, albedo=pk.r11g11b10(d["albedo"]),
                            f0=sr[:, :3], roughness=sr[:, 3])


def _foreground(d: dict, k: int | None = None) -> dict:
    keep = torch.nonzero(d["depth"] != BACKGROUND_DEPTH)[:, 0][:k]
    return {key: (v[keep] if torch.is_tensor(v) else v)
            for key, v in d.items()}


def _di(ev, scene, spec, seed, control) -> dict:
    d = _foreground(ev["di"])
    s = _shading(ev, d)
    lights = lighting.triangle_lights(scene)
    valid, index = pk.reservoir_light(d["light_data"])
    index = torch.where(valid, index, -1)
    uv0 = pk.reservoir_uv(d["uv_data"])

    def shade(uv, dtype=torch.float32):
        return torch.cat(lighting.shade_sample(
            scene, lights, s, index, uv, d["weight"], d["final_visibility"],
            dtype), -1).double()

    # the stored uv was truncated to 16 bits: the sample lies between the
    # corners of that step, and so does its shading
    step = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]],
                        device=uv0.device) / 65535.0
    ref = torch.stack([shade(torch.clamp_max(uv0 + c, 1.0)) for c in step])
    lo, hi = ref.min(0).values, ref.max(0).values
    g = ev["mix"]["gconst"]
    new = torch.cat([d["diffuse"], d["specular"]], -1).double()
    prior = torch.cat([d["prior_diffuse"], d["prior_specular"]], -1).double()
    # the frame's own contribution, from StoreShadingOutput's blend, and
    # what float32 rounding of that blend can move it by
    if g.get("enable_accumulation", 0):
        bf = d["blend"]
        got = prior + (new - prior) / bf
        slack = 2.0 ** -22 * ((new.abs() + prior.abs()) / bf + prior.abs())
    elif g.get("enable_restir_di", 0) != 1:
        got, slack = new - prior, 2.0 ** -22 * (new.abs() + prior.abs())
    else:
        got, slack = new, 2.0 ** -22 * new.abs()
    if control:
        got = shade(uv0, CONTROL_DTYPE)
    mag = torch.maximum(lo.abs(), hi.abs())
    tol = DI_REL * mag + slack + DI_ABS
    bad = ((got < lo - tol) | (got > hi + tol)).any(-1)
    lit = (mag > DI_ABS).any(-1)
    return {"di_bad_share": float(bad.float().mean()),
            "di_pixels": int(bad.numel()),
            "di_lit_pixels": int(lit.sum())}


def _di_energy(ev, scene, spec, seed, control) -> dict:
    d = _foreground(ev["di"], spec["pixels"])
    s = _shading(ev, d)
    lights = lighting.triangle_lights(scene)
    ref = lighting.many_light(scene, lights, s, spec["subdivisions"])
    if control:
        got = lighting.many_light(scene, lights, s, spec["subdivisions"],
                                  CONTROL_DTYPE)
    else:
        got = d["diffuse"] * s.albedo + d["specular"] * torch.clamp_min(
            s.f0, lighting.F0_FLOOR)
    ratio = float(got.double().sum() / ref.double().sum())
    return {"di_energy_err": abs(ratio - 1.0) * ev["accumulated"] ** 0.5,
            "di_energy_pixels": int(ref.shape[0])}


# the checks that read the window's sampled rays, and where they keep them
SAMPLED = {"trace": "closest", "occluded": "occluded"}
CHECKS = {"trace": _trace, "occluded": _occluded, "gbuffer": _gbuffer,
          "post": _post, "radiance": _radiance, "di": _di,
          "di_energy": _di_energy}


@functools.cache
def load_check(name: str):
    """checks/<name>.py as a module (a name may hold dots)."""
    path = Path(__file__).resolve().parent / "checks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_check_" + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numbers(ev: dict, glb: bytes, cell, device, control: bool = False
            ) -> dict:
    """Every number the cell's mix asks for, from the run's evidence."""
    scene = load_glb(glb, device)
    out = {}
    seed = ev["seed"]
    for name, spec in cell.mix["checks"].items():
        if name in SAMPLED and SAMPLED[name] not in ev:
            # the window traced nothing to compare
            out[f"{name}_rays"] = 0
            if name == "trace":
                out["frames_untraced"] = ev["frames"] - ev["traced"]
            continue
        fn = CHECKS[name] if name in CHECKS else load_check(name).numbers
        out.update(fn(ev, scene, spec, seed, control))
    return out


def judge(nums: dict, limits: dict) -> dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}: a number is
    within its limit where it is at most "max" or at least "min"; a number
    without a limit, or a limit without a number, fails."""
    checks, ok = {}, set(nums) == set(limits)
    for name in sorted(set(nums) | set(limits)):
        lim = limits.get(name, {})
        v = nums.get(name)
        if v is None or not lim:
            ok = False
            checks[name] = {"value": v, "limit": lim.get("text", "none")}
            continue
        if "max" in lim:
            good, text = v <= lim["max"], f"<= {lim['max']}"
        else:
            good, text = v >= lim["min"], f">= {lim['min']}"
        ok = ok and good
        checks[name] = {"value": v, "limit": text}
    return {"correct": bool(ok), "checks": checks}
