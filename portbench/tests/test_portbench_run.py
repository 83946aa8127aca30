"""The harness end to end on the CPU at a tiny size: a sound run comes out
correct; the control (the reference in bfloat16 in the program's place)
and each fault the cells can have come out not correct; the measurement
path refuses to run without a card; and nothing the run or the reference
loads is JAX or the JAX package."""

import subprocess
import sys

import pytest
import torch

from portbench import check, harness
from portbench.reference.glb import load_glb

from .conftest import CELLS, ROOT, run_tiny, tiny_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer2_tpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_tiny(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {
        m["name"] for m in harness.load_cell(
            name, harness.load_spec()).metrics_e2e}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = run_tiny(tiny_cell(name), control=True)
    assert not out["correct"], out["checks"]


def _direct_numbers(ev, glb, cell, control=False):
    """check.numbers as it read while every check was one of CHECKS."""
    scene = load_glb(glb, torch.device("cpu"))
    out = {}
    for name, spec in cell.mix["checks"].items():
        if name in check.SAMPLED and check.SAMPLED[name] not in ev:
            out[f"{name}_rays"] = 0
            if name == "trace":
                out["frames_untraced"] = ev["frames"] - ev["traced"]
            continue
        out.update(check.CHECKS[name](ev, scene, spec, ev["seed"], control))
    return out


def _builtin_checks_only(name: str) -> bool:
    cell = harness.load_cell(name, harness.load_spec())
    return set(cell.mix["checks"]) <= set(check.CHECKS)


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if _builtin_checks_only(n)])
def test_builtin_checks_read_as_through_checks_directly(name, monkeypatch):
    """A cell whose checks are all check.py's own loads nothing of checks/,
    and a run's compared numbers are, bit for bit, those of CHECKS called
    by name on the same evidence."""
    seen, real = {}, check.numbers

    def keep(ev, glb, cell, device, control=False):
        seen.update(ev=ev, glb=glb)
        return real(ev, glb, cell, device, control)

    def refuse(name):
        raise AssertionError(f"loaded checks/{name}.py")

    monkeypatch.setattr(check, "numbers", keep)
    monkeypatch.setattr(check, "load_check", refuse)
    cell = tiny_cell(name)
    out = run_tiny(cell, seconds=0.0)  # one window frame
    assert out["correct"], out["checks"]
    got = {k: c["value"] for k, c in out["checks"].items()}
    assert got == _direct_numbers(seen["ev"], seen["glb"], cell)


def _frozen_frame(monkeypatch):
    """A frame that returns its state unchanged (and last frame's image)."""
    from raytracer2_tpu_torch.render import frame as fr

    real, last = fr.render_frame, {}

    def frozen(renderer, g, state, *args, **kwargs):
        if "img" not in last:
            last["state"], last["img"] = real(renderer, g, state, *args,
                                              **kwargs)
        return state, last["img"]

    monkeypatch.setattr(fr, "render_frame", frozen)


def _half_batch(monkeypatch):
    """The closest-hit walk answers only the first half of each batch: the
    rest come back as misses."""
    from raytracer2_tpu_torch.ops import cuda_traverse as ct

    real = ct.closest_hit_bundle

    def half(*args, **kwargs):
        rec, n_fb = real(*args, **kwargs)
        n = rec.t.shape[0]
        keep = torch.arange(n) < n // 2
        return rec._replace(
            geometry_index=torch.where(keep, rec.geometry_index, 0xFFFFFFFF),
            triangle_index=torch.where(keep, rec.triangle_index, -1)), n_fb

    monkeypatch.setattr(ct, "closest_hit_bundle", half)


def _altered_answer(monkeypatch):
    """The closest-hit walk's t comes back 1% long where it is produced."""
    from raytracer2_tpu_torch.ops import cuda_traverse as ct

    real = ct.closest_hit_bundle

    def altered(*args, **kwargs):
        rec, n_fb = real(*args, **kwargs)
        return rec._replace(t=rec.t * 1.01), n_fb

    monkeypatch.setattr(ct, "closest_hit_bundle", altered)


def _brighter_light(monkeypatch):
    """The DI pass shades its light sample 1% brighter where it is
    produced."""
    from raytracer2_tpu_torch.render import di_passes

    real = di_passes.shade_surface_with_light_sample

    def brighter(*args, **kwargs):
        res, diffuse, specular, dist = real(*args, **kwargs)
        return res, diffuse * 1.01, specular * 1.01, dist

    monkeypatch.setattr(di_passes, "shade_surface_with_light_sample",
                        brighter)


def _stale_light(monkeypatch):
    """The DI pass returns the lighting planes it was given."""
    from raytracer2_tpu_torch.render import frame as fr

    real = fr.di_fused_resampling_pass

    def stale(g, bridge, ctx, diffuse, specular, *args, **kwargs):
        res, _, _ = real(g, bridge, ctx, diffuse, specular, *args, **kwargs)
        return res, diffuse, specular

    monkeypatch.setattr(fr, "di_fused_resampling_pass", stale)


def _sees_di(name: str) -> bool:
    return "di" in harness.load_cell(name, harness.load_spec()).mix["checks"]


# every fault a cell can have: the DI faults where the check sees DI
FAULTS = [(name, fault) for name in CELLS
          for fault in (_frozen_frame, _half_batch, _altered_answer)] + [
    (name, fault) for name in CELLS if _sees_di(name)
    for fault in (_brighter_light, _stale_light)]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(tiny_cell(name))
    assert not out["correct"], out["checks"]


def test_measurement_path_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "ladder-1080p.restir", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "GPU only" in res.stderr


def test_run_and_reference_load_no_jax():
    """A whole tiny run in a fresh process loads neither JAX nor the JAX
    package (top-level names compared whole), and the plain reference on
    its own loads nothing of the program."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
import conftest
conftest.run_tiny(conftest.tiny_cell("ladder-1080p.refmode"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
assert "raytracer2_tpu_torch" in sys.modules
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600,
                   cwd=ROOT)
    ref = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from portbench import check, scenes
from portbench.reference import agx, camera, glb, intersect, pathtrace
s = glb.load_glb(scenes.GENERATORS["emissive_stress_glb"](num_lights=4),
                 torch.device("cpu"))
px = torch.tensor([3, 40]); py = torch.tensor([5, 20])
pose = {{"position": [0.0, 10.0, -52.0], "direction": [0.0, 0.25, -1.0]}}
pathtrace.radiance(s, px, py, pose, 64, 32, 7, samples=2, bounces=2)
agx.tonemap(torch.rand(4, 3))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r} + ("raytracer2_tpu_torch",))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", ref], check=True, timeout=300,
                   cwd=ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")
    res = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         name, "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    import json
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
