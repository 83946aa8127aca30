"""The app of the PyTorch port (python -m raytracer2_tpu_torch.app) against
the JAX app on the same flags.

Both apps render the procedural Cornell box through the lbvh backend at
24x16 for 2 frames and write a checkpoint, then resume from the JAX app's
checkpoint for 1 frame. Every PNG matches the JAX app's within 1 level
(the frames' rtol = atol = 2e-3), metrics.json has the same keys, the
port's checkpoint loads through the JAX app's load_checkpoint into its
frame-state template leaf for leaf, and the port's --animate, --orbit and
--checkerboard runs stay finite. The PNGs are the port's own
(utils/png.py, no PIL); PIL decodes both apps' here.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from raytracer2_tpu import app as japp
from raytracer2_tpu import compile_cache
from raytracer2_tpu.render.frame import init_frame_state as j_init_state
from raytracer2_tpu_torch import app
from raytracer2_tpu_torch.utils.png import read_png, write_png

SIZE = ["--width", "24", "--height", "16"]
FLAGS = ["--backend", "lbvh"] + SIZE
METRIC_KEYS = {"traversal_overflow", "frames", "p50_ms", "mean_ms", "fps",
               "telemetry"}


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output directories of the JAX app (fresh, resumed) and of the port's
    app (fresh, resumed from the JAX app's checkpoint)."""
    root = tmp_path_factory.mktemp("app")
    d = {k: root / k for k in ("jax", "jax_resume", "port", "port_resume")}
    with pytest.MonkeyPatch.context() as mp:
        # keep the JAX app's persistent compile cache out of this process
        mp.setattr(compile_cache, "enable_compile_cache", lambda: False)
        assert japp.main(FLAGS + ["--frames", "2", "--out", str(d["jax"]),
                                  "--checkpoint", str(root / "jax.npz")]) == 0
        assert japp.main(FLAGS + ["--frames", "1",
                                  "--out", str(d["jax_resume"]),
                                  "--resume", str(root / "jax.npz")]) == 0
    assert app.main(FLAGS + ["--device", "cpu", "--frames", "2",
                             "--out", str(d["port"]),
                             "--checkpoint", str(root / "port.npz")]) == 0
    assert app.main(FLAGS + ["--device", "cpu", "--frames", "1",
                             "--out", str(d["port_resume"]),
                             "--resume", str(root / "jax.npz")]) == 0
    return root, d


@pytest.mark.parametrize("run,frame", [("", 0), ("", 1), ("_resume", 2)])
def test_pngs_match_the_jax_app(runs, run, frame):
    _, d = runs
    name = f"frame_{frame:04d}.png"
    got = _png(d["port" + run] / name)
    want = _png(d["jax" + run] / name)
    assert got.shape == want.shape == (16, 24, 3)
    assert np.abs(got - want).max() <= 1
    assert got.mean() > 1.0  # the lit box, not a black frame
    np.testing.assert_array_equal(read_png(d["port" + run] / name), got)


def test_metrics_have_the_jax_keys(runs):
    _, d = runs
    for run in ("", "_resume"):
        got = json.loads((d["port" + run] / "metrics.json").read_text())
        want = json.loads((d["jax" + run] / "metrics.json").read_text())
        assert set(got) == set(want) == METRIC_KEYS
        assert set(got["telemetry"]) == set(want["telemetry"])
        assert got["frames"] == want["frames"]
        assert got["telemetry"]["rays"]["count"] == \
            want["telemetry"]["rays"]["count"]
        # lbvh has no candidate budget to overflow, in either app
        assert got["traversal_overflow"] is want["traversal_overflow"] is None


def test_checkpoints_cross_between_the_apps(runs):
    """The port's checkpoint through the JAX app's loader into the JAX
    frame state: the same leaves, dtypes and values as written; and the
    JAX app's checkpoint through the port's loader back again."""
    root, _ = runs
    port = np.load(root / "port.npz")
    state, frame = japp.load_checkpoint(root / "port.npz",
                                        j_init_state(24, 16))
    assert frame == 2 == int(np.load(root / "jax.npz")["frame"])
    leaves = jax.tree_util.tree_leaves(state)
    assert len(leaves) == len([k for k in port.files if k.startswith("leaf")])
    for i, leaf in enumerate(leaves):
        a = port[f"leaf_{i}"]
        assert np.asarray(leaf).dtype == a.dtype, i
        np.testing.assert_array_equal(np.asarray(leaf), a)
    # the JAX checkpoint's dtypes are the port's written ones
    jx = np.load(root / "jax.npz")
    for i in range(len(leaves)):
        assert jx[f"leaf_{i}"].dtype == port[f"leaf_{i}"].dtype
        assert jx[f"leaf_{i}"].shape == port[f"leaf_{i}"].shape

    from raytracer2_tpu_torch.render.frame import init_frame_state

    template = init_frame_state(24, 16, device="cpu")
    restored, frame = app.load_checkpoint(root / "jax.npz", template)
    assert frame == 2
    for i, (a, b) in enumerate(zip(app._flatten(restored),
                                   app._flatten(template))):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(
            a.numpy().astype(jx[f"leaf_{i}"].dtype), jx[f"leaf_{i}"])


@pytest.mark.parametrize("extra", [
    ["--animate", "ANIMATE"], ["--orbit"], ["--checkerboard"]])
def test_app_options_render_finite(tmp_path, extra):
    animate = tmp_path / "animate.json"
    animate.write_text(json.dumps({"1": {"enable_restir_gi": 0}}))
    extra = [str(animate) if a == "ANIMATE" else a for a in extra]
    out = tmp_path / "out"
    assert app.main(["--device", "cpu", "--frames", "2", "--out", str(out),
                     "--checkpoint", str(tmp_path / "c.npz")] + SIZE
                    + extra) == 0
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["frames"] == 2 and np.isfinite(metrics["p50_ms"])
    # the bundle walk's budgets were sized by the probe and are reported
    assert metrics["traversal_overflow"] in (True, False)
    for f in (0, 1):
        assert read_png(out / f"frame_{f:04d}.png").shape == (16, 24, 3)
    ckpt = np.load(tmp_path / "c.npz")
    for k in ckpt.files:
        if ckpt[k].dtype == np.float32:
            assert np.isfinite(ckpt[k]).all(), k


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--frames", "1", "--out", str(tmp_path)] + SIZE)
    assert not any(tmp_path.iterdir())


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3),
                                            dtype=np.uint8)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(_png(tmp_path / "a.png"), img)
    with pytest.raises(ValueError):
        write_png(tmp_path / "b.png", img.astype(np.float32))
    damaged = bytearray((tmp_path / "a.png").read_bytes())
    damaged[40] ^= 0xFF
    (tmp_path / "c.png").write_bytes(bytes(damaged))
    with pytest.raises(ValueError):
        read_png(tmp_path / "c.png")
