"""The port against the checked-in golden images (tests/goldens/*.npy).

The port renders the frame tests/test_goldens.py sets up, rebuilt from its
own modules: the procedural Cornell box at 16x16, the camera at (0, 0, -12)
looking along (0, 0, -1), the default GConst with DI, GI, GI temporal and
GI spatial resampling on, two frames from a fresh state. Only the .npy
files of the JAX package are read; the JAX package is not run. Depth,
diffuse, specular and display must agree within the goldens' own
rtol=atol=2e-3 and the packed normals bit for bit.

The goldens' camera sits on the box's axis, so the primary rays of the
pixels on the image's diagonals run exactly along the diagonals of the
wall quads, where hit or miss (or which wall of a corner) is a rounding
coin-flip between two tracers. EDGE_TIES lists the pixels whose depth or
normal differ for that reason (the G-buffer's depth and normal only: the
lighting images agree everywhere); test_edge_ties_are_edge_rays checks
that each of them is such a ray. Every other pixel is held to the goldens.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer2_tpu_torch.models import procedural as proc
from raytracer2_tpu_torch.params import default_gconst
from raytracer2_tpu_torch.render.frame import (
    create_renderer, init_frame_state, render_frame)
from raytracer2_tpu_torch.scene import gltf
from raytracer2_tpu_torch.scene.camera import default_camera
from raytracer2_tpu_torch.scene.scene import build_scene

W = H = 16
CPU = torch.device("cpu")
GOLDEN_DIR = Path(__file__).parent / "goldens"
CASES = ("depth", "normals_bits", "diffuse", "specular", "display")
# (y, x) of the primary rays that run along a wall quad's diagonal and hit
# where the goldens' tracer missed, or hit the other wall of a corner
EDGE_TIES = {(2, 2), (2, 13), (12, 3), (12, 12), (13, 2), (13, 13), (15, 0),
             (15, 15)}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    p = tmp_path_factory.mktemp("goldens") / "c.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    scene = build_scene(gltf.load_file(p), device=CPU)
    renderer = create_renderer(scene, W, H)
    cam = default_camera(window_size=(W, H), position=(0, 0, -12),
                         direction=(0, 0, -1))
    g = default_gconst(cam.planar_view_constants(),
                       renderer.scene_lights.num_local_lights,
                       enable_restir_di=1, enable_restir_gi=1,
                       enable_temporal_resampling=1,
                       enable_spatial_resampling=1)
    state = init_frame_state(W, H, device=CPU)
    for f in range(2):
        state, img = render_frame(renderer, g.replace(frame=f), state)
    return {
        "renderer": renderer, "view": g.view,
        "depth": state.gbuffer.depth.numpy(),
        "normals_bits": state.gbuffer.normals.numpy(),
        "diffuse": state.diffuse_lighting.numpy(),
        "specular": state.specular_lighting.numpy(),
        "display": img.numpy(),
    }


@pytest.mark.parametrize("name", CASES)
def test_port_matches_golden(outputs, name):
    want = np.load(GOLDEN_DIR / f"{name}.npy")
    got = outputs[name]
    assert got.shape == want.shape
    if name == "normals_bits":
        same = got == want
    else:
        same = np.isclose(got, want, rtol=2e-3, atol=2e-3)
    if same.ndim == 3:
        same = same.all(axis=-1)
    differ = {(int(y), int(x)) for y, x in np.argwhere(~same)}
    assert differ <= EDGE_TIES, sorted(differ - EDGE_TIES)
    if name in ("diffuse", "specular", "display"):
        assert not differ


def test_edge_ties_are_edge_rays(outputs):
    """The primary ray of each EDGE_TIES pixel hits its triangle within
    float32 rounding of an edge (a barycentric coordinate within 1e-5 of
    0), where two tracers may differ; it runs along a quad's diagonal."""
    from raytracer2_tpu_torch.render import rays as raysmod

    ys, xs = zip(*sorted(EDGE_TIES))
    px = torch.tensor(xs, dtype=torch.int32)
    py = torch.tensor(ys, dtype=torch.int32)
    ray = raysmod.setup_primary_ray(px, py, outputs["view"])
    hit = outputs["renderer"].tracers.closest_hit(
        ray.origin, ray.direction, ray.t_min, ray.t_max, presorted=False)
    assert not hit.missed.any()
    w = 1.0 - hit.u - hit.v
    edge = torch.minimum(torch.minimum(hit.u, hit.v), w)
    assert (edge.abs() < 1e-5).all(), edge
    assert all(x == y or x + y == W - 1 for y, x in EDGE_TIES)
