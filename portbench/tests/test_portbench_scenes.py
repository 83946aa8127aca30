"""The frozen scene generators write the same GLB bytes as the program's
generators today, and the reference reads them as the program does."""

import pytest
import torch

from portbench import harness, scenes
from portbench.reference import lighting
from portbench.reference.glb import load_glb


@pytest.mark.parametrize("name", sorted(scenes.GENERATORS))
def test_frozen_generators_match_the_program(name):
    from raytracer2_tpu_torch.models import procedural

    spec = harness.load_spec()
    for conf in spec["configs"]:
        cfg = harness.load_cell(
            [w["name"] for w in spec["workloads"]
             if w["config"] == conf["name"]][0], spec).config
        if cfg["generator"] != name:
            continue
        ours = scenes.GENERATORS[name](**cfg["args"])
        theirs = getattr(procedural, name)(**cfg["args"])
        assert ours == theirs


@pytest.mark.parametrize("name", ["ladder-1080p.restir",
                                  "emissive-1080p.di-vis"])
def test_reference_scene_matches_the_program_import(name, tmp_path):
    from raytracer2_tpu_torch.scene import gltf
    from raytracer2_tpu_torch.scene.scene import scene_arrays

    cfg = harness.load_cell(name, harness.load_spec()).config
    glb = scenes.GENERATORS[cfg["generator"]](**cfg["args"])
    ref = load_glb(glb, torch.device("cpu"))
    path = tmp_path / "s.glb"
    path.write_bytes(glb)
    prog = scene_arrays(gltf.load_file(path))
    assert ref.num_triangles == cfg["triangles"] == prog["num_triangles"]
    assert torch.equal(ref.v0, torch.from_numpy(prog["tri_v0"]))
    assert torch.equal(ref.e1, torch.from_numpy(prog["tri_edge1"]))
    assert torch.equal(ref.e2, torch.from_numpy(prog["tri_edge2"]))
    assert int((ref.emission.abs().sum(-1) > 0).sum()) == \
        cfg["emissive_triangles"] == prog["num_emissive_triangles"]


@pytest.mark.parametrize("name", ["ladder-1080p.restir",
                                  "emissive-1080p.di-vis"])
def test_reference_lights_are_the_program_light_table(name, tmp_path):
    """Light index i is the reference's i-th emissive triangle, with the
    radiance the program's light record keeps."""
    from raytracer2_tpu_torch.lights.polymorphic import (
        _create_triangle, gather_light)
    from raytracer2_tpu_torch.lights.prepare import prepare_lights
    from raytracer2_tpu_torch.scene import gltf
    from raytracer2_tpu_torch.scene.scene import build_scene

    cfg = harness.load_cell(name, harness.load_spec()).config
    glb = scenes.GENERATORS[cfg["generator"]](**cfg["args"])
    path = tmp_path / "s.glb"
    path.write_bytes(glb)
    prog = prepare_lights(build_scene(gltf.load_file(path),
                                      device=torch.device("cpu")))
    ref = lighting.triangle_lights(load_glb(glb, torch.device("cpu")))
    n = ref.v0.shape[0]
    assert n == prog.num_local_lights == cfg["emissive_triangles"]
    base, e1, e2, radiance, normal, area = _create_triangle(
        gather_light(prog.lights, torch.arange(n)))
    assert torch.equal(radiance, ref.radiance)
    # the record keeps the edges as octahedral directions and half-float
    # lengths
    for got, want in ((base, ref.v0), (e1, ref.e1), (e2, ref.e2)):
        assert torch.allclose(got, want, atol=1e-3)
    assert torch.allclose(normal, ref.normal, atol=1e-4)
    assert torch.allclose(area, ref.area, rtol=1e-3)


def test_many_light_quadrature_converges():
    """The fixed quadrature at 3x3 parts a triangle agrees with a 12x12 one
    within 0.3% at points a light's size or more below the lights."""
    scene = load_glb(scenes.GENERATORS["emissive_stress_glb"](num_lights=16),
                     torch.device("cpu"))
    lights = lighting.triangle_lights(scene)
    pos = torch.tensor([[0.0, 0.0, 0.0], [-20.0, 0.0, 10.0], [3.0, 0.0, -7.5],
                        [11.0, 0.0, 11.0]])
    n = pos.shape[0]
    up = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3)
    s = lighting.Shading(pos=pos, normal=up, view=up,
                         albedo=torch.full((n, 3), 0.6),
                         f0=torch.full((n, 3), 0.6),
                         roughness=torch.ones(n))
    coarse = lighting.many_light(scene, lights, s, 3)
    fine = lighting.many_light(scene, lights, s, 12)
    assert (fine > 0).all()
    assert torch.allclose(coarse, fine, rtol=3e-3)
