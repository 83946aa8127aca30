"""The PyTorch port never imports JAX: the machine with the GPU has none."""

import os
import pathlib
import re
import subprocess
import sys

import raytracer2_tpu_torch

PACKAGE = pathlib.Path(raytracer2_tpu_torch.__file__).resolve().parent
REPO = PACKAGE.parent

_PROBE = """
import importlib, pkgutil, sys
import raytracer2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
jax_free = not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
old = sorted(m for m in sys.modules
             if m == "raytracer2_tpu" or m.startswith("raytracer2_tpu."))
print(len(names), jax_free, ",".join(names), ",".join(old))
"""

# the modules of the GI slice, the dense cull, the pair engine, the
# environment slice, the app slice (app, viewer, lbvh, PNG), the
# multi-device slice, the tracer-configuration slice (the XLA bundle and
# scatter engines, the candidate preps of every cull) and the build cache,
# named so that a missing one fails here rather than go unprobed
SLICE_MODULES = {
    "raytracer2_tpu_torch.ops.cull",
    "raytracer2_tpu_torch.ops.cuda_pairs",
    "raytracer2_tpu_torch.ops.binning",
    "raytracer2_tpu_torch.restir.gi_reservoir",
    "raytracer2_tpu_torch.restir.gi_resampling",
    "raytracer2_tpu_torch.render.gi_passes",
    "raytracer2_tpu_torch.render.banding",
    "raytracer2_tpu_torch.scene.exr",
    "raytracer2_tpu_torch.scene.piz",
    "raytracer2_tpu_torch.utils.profiler",
    "raytracer2_tpu_torch.app",
    "raytracer2_tpu_torch.viewer",
    "raytracer2_tpu_torch.ops.bvh",
    "raytracer2_tpu_torch.ops.traverse",
    "raytracer2_tpu_torch.utils.png",
    "raytracer2_tpu_torch.parallel",
    "raytracer2_tpu_torch.parallel.mesh",
    "raytracer2_tpu_torch.parallel.halo",
    "raytracer2_tpu_torch.parallel.dryrun",
    "raytracer2_tpu_torch.ops.traverse_bundle",
    "raytracer2_tpu_torch.ops.traverse_scatter",
    "raytracer2_tpu_torch.ops.cuda_traverse",
    "raytracer2_tpu_torch.ops.cluster",
    "raytracer2_tpu_torch.ops.wald",
    "raytracer2_tpu_torch.render.app_bridge",
    "raytracer2_tpu_torch.compile_cache",
}

# the JAX package's modules the port may load: none (the port keeps its own
# copies of the host modules it needs)
SHARED = set()


def test_every_submodule_imports_without_jax():
    """Every port module and chip_smoke.py's imports load neither JAX nor
    any module of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    n_modules, jax_free = int(out[0]), out[1]
    old = set(out[3].split(",")) if len(out) > 3 else set()
    assert n_modules >= 64
    assert SLICE_MODULES <= set(out[2].split(","))
    assert jax_free == "True"
    assert old <= SHARED, old - SHARED


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax\b)", re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 1
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders
