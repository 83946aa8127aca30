"""The reference-mode slice of the PyTorch port against the JAX package.

Both packages render the same Cornell box (the JAX scene and GConst carried
across with raytracer2_tpu_torch.convert) at 16x16. A hit that flips at a
triangle edge sends one path elsewhere, so a few pixels may differ; the bar
is rtol=atol=2e-3 on at least 99% of the values and a mean |diff| <= 1e-3.

The camera sits slightly off the box's axis. On the axis, the pixels of the
image diagonal cast rays exactly along the diagonal edges of the wall quads,
where the last bit of each package's float arithmetic decides hit or miss;
that compares two rounding orders, not the two renderers.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer2_tpu.models import procedural as proc
from raytracer2_tpu.params import default_gconst
from raytracer2_tpu.render import frame as jframe
from raytracer2_tpu.render.reference import render_reference as j_render
from raytracer2_tpu.scene import gltf
from raytracer2_tpu.scene.camera import default_camera
from raytracer2_tpu.scene.scene import build_scene as j_build_scene
from raytracer2_tpu_torch import convert
from raytracer2_tpu_torch.render import frame as tframe
from raytracer2_tpu_torch.render.reference import render_reference

W = H = 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    p = tmp_path_factory.mktemp("ref") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    j_scene = j_build_scene(gltf.load_file(p))
    cam = default_camera(window_size=(W, H), position=(0.13, 0.07, -12),
                         direction=(0, 0, -1))
    j_g = default_gconst(cam.planar_view_constants(),
                         j_scene.num_emissive_triangles, refrence_mode=1)
    t_scene = convert.scene_from_numpy(convert.to_numpy_tree(j_scene),
                                       device=CPU)
    t_g = convert.gconst_from_numpy(convert.to_numpy_tree(j_g))
    return j_scene, j_g, t_scene, t_g


def _assert_images_close(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    close = np.isclose(got, want, rtol=2e-3, atol=2e-3)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} differ"
    assert np.abs(got - want).mean() <= 1e-3


@pytest.mark.parametrize("tracer,options", [
    ("brute", {}),
    ("bundle", {}),
    # several Z-order chunks with a padded last one, front-face emission
    ("bundle", dict(chunk_pixels=96, emission_facing="front")),
])
def test_render_reference_matches_jax(cornell, tracer, options):
    j_scene, j_g, t_scene, t_g = cornell
    want = j_render(j_scene, j_g, W, H, max_bounces=3, max_samples=2,
                    **options)
    trace_fn = None
    if tracer == "bundle":
        trace_fn = tframe.create_renderer(t_scene, W, H).tracers.closest_hit
    got, live = render_reference(t_scene, t_g, W, H, max_bounces=3,
                                 max_samples=2, trace_fn=trace_fn,
                                 with_ray_count=True, **options)
    _, want_live = j_render(j_scene, j_g, W, H, max_bounces=3, max_samples=2,
                            with_ray_count=True, **options)
    assert live == int(want_live)
    assert float(np.asarray(want).max()) > 10.0  # the light is in view
    _assert_images_close(got, want)


def test_render_frame_reference_mode_matches_jax(cornell, monkeypatch):
    """The reference branch of render_frame (trace, store, post-process) in
    both packages; both frames trace 2 spp and 3 bounces, not the default
    12 and 5, to keep the test short."""
    j_scene, j_g, t_scene, t_g = cornell
    for module in (jframe, tframe):
        monkeypatch.setattr(module, "render_reference", functools.partial(
            module.render_reference, max_bounces=3, max_samples=2))
    j_renderer = jframe.create_renderer(j_scene, W, H, backend="bundle",
                                        presample=False)
    _, want = jframe.render_frame(j_renderer, j_g,
                                  jframe.init_frame_state(W, H))

    renderer = tframe.create_renderer(t_scene, W, H, backend="auto")
    state = tframe.init_frame_state(W, H, device=CPU)
    state, got = tframe.render_frame(renderer, t_g, state)
    assert got.shape == (H, W, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert float(got.max()) > 0.05
    assert state.diffuse_lighting.shape == (H, W, 3)
    _assert_images_close(got, want)


@pytest.mark.parametrize("refrence_mode", [1, 0])
@pytest.mark.parametrize("environment", [0, 1])
def test_post_process_matches_jax(cornell, refrence_mode, environment):
    """AgX post-process, both branches: the reference passthrough and the
    lit composite with environment background and motion."""
    from raytracer2_tpu.render import postprocess as jpp
    from raytracer2_tpu_torch.render import postprocess as tpp

    j_scene, j_g, t_scene, t_g = cornell
    rng = np.random.default_rng(10)
    arrays = {f: rng.uniform(0.0, 4.0, (H, W, 3)).astype(np.float32)
              for f in jpp.PostProcessInputs._fields if f != "depth"}
    depth = rng.uniform(1.0, 50.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.3] = 100000.0  # background pixels
    arrays["depth"] = depth
    arrays["diffuse"][0, 0] = np.nan  # the NaN canary turns it red
    j_g = j_g.replace(refrence_mode=refrence_mode, environment=environment)
    t_g = t_g.replace(refrence_mode=refrence_mode, environment=environment)
    want = jpp.post_process(j_scene, j_g, jpp.PostProcessInputs(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    got = tpp.post_process(t_scene, t_g, tpp.PostProcessInputs(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}))
    # AgX's sigmoid fit sums terms as large as ~40 (float32 ulp ~4e-6) down
    # to [0, 1], so the two packages' rounding may differ by a few 1e-6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tpp.to_srgb_u8(got[0]).numpy(),
                                  np.asarray(jpp.to_srgb_u8(want[0])))


@pytest.mark.parametrize("accumulate,correct", [(0, 0), (1, 0), (1, 1)])
@pytest.mark.parametrize("first", [True, False])
def test_store_shading_output_matches_jax(accumulate, correct, first):
    from raytracer2_tpu.render import shading as jsh
    from raytracer2_tpu_torch.render import shading as tsh

    rng = np.random.default_rng(11)
    a = [rng.uniform(size=(4, 5, 3)).astype(np.float32) for _ in range(4)]
    mask = rng.uniform(size=(4, 5)) < 0.5
    kw = dict(is_first_pass=first, enable_accumulation=accumulate,
              blend_factor=0.25, correct_specular_accumulation=bool(correct))
    want = jsh.store_shading_output(*map(jnp.asarray, a),
                                    write_mask=jnp.asarray(mask), **kw)
    got = tsh.store_shading_output(*map(torch.from_numpy, a),
                                   write_mask=torch.from_numpy(mask), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
