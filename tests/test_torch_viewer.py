"""The terminal viewer of the PyTorch port (viewer.py), its camera controls
(scene/camera.py: Controls, Camera.update) and PassTimer's telemetry
(utils/profiler.py) against the JAX package on the same inputs, and the
viewer's loop on a pseudo-terminal with a stub frame."""

import io
import itertools
import os
import sys

import numpy as np
import pytest

from raytracer2_tpu import viewer as jviewer
from raytracer2_tpu.params import default_gconst as j_default_gconst
from raytracer2_tpu.scene import camera as jcam
from raytracer2_tpu.utils.profiler import PassTimer as JPassTimer
from raytracer2_tpu_torch import viewer as tviewer
from raytracer2_tpu_torch.params import default_gconst
from raytracer2_tpu_torch.scene import camera as tcam
from raytracer2_tpu_torch.utils.profiler import PassTimer

START = dict(window_size=(64, 48), position=(0.5, -1.0, 10.0),
             direction=(0.1, 0.2, 1.0), fov=60.0)


def _cameras():
    return jcam.default_camera(**START), tcam.default_camera(**START)


def _same_camera(a, b) -> None:
    assert a.position == b.position
    assert a.direction == b.direction
    for f in a.planar_view_constants()._fields:
        np.testing.assert_array_equal(getattr(a.planar_view_constants(), f),
                                      getattr(b.planar_view_constants(), f))


MOVES = ("go_forward", "go_backward", "strafe_right", "strafe_left",
         "go_up", "go_down")


@pytest.mark.parametrize("look", [(0.0, 0.0), (40.0, 0.0), (-25.0, 60.0)])
def test_camera_update_matches_jax(look):
    """Every pair of move flags, with and without a look, over two steps."""
    j0, t0 = _cameras()
    for a, b in itertools.combinations_with_replacement(MOVES, 2):
        kw = dict({a: True, b: True}, look_around=look != (0.0, 0.0),
                  cursor_delta=look)
        j, t = j0, t0
        for dt in (1 / 30, 0.2):
            j = j.update(jcam.Controls(**kw), dt)
            t = t.update(tcam.Controls(**kw), dt)
        _same_camera(j, t)
    assert tcam.MOVE_SPEED == jcam.MOVE_SPEED
    assert tcam.ANGLE_PER_POINT == jcam.ANGLE_PER_POINT


@pytest.mark.parametrize("keys", ["", "w", "wasdqe", "ijkl", "ll1", "2345",
                                  "6w", "x", "\x1b", "aj\x03"])
def test_apply_keys_matches_jax(keys):
    jc, tc = _cameras()
    jg = j_default_gconst(jc.planar_view_constants(), 3)
    tg = default_gconst(tc.planar_view_constants(), 3)
    jc2, jg2, jq = jviewer.apply_keys(keys, jc, jg, dt=0.05)
    tc2, tg2, tq = tviewer.apply_keys(keys, tc, tg, dt=0.05)
    assert jq == tq
    _same_camera(jc2, tc2)
    for field in tviewer._TOGGLE_KEYS.values():
        assert int(getattr(tg2, field)) == int(getattr(jg2, field)), field


def test_image_to_ansi_matches_jax():
    img = np.random.default_rng(4).integers(0, 256, (37, 53, 3),
                                            dtype=np.uint8)
    for cols, rows in ((4, 2), (53, 19), (80, 30)):
        assert (tviewer.image_to_ansi(img, cols, rows)
                == jviewer.image_to_ansi(img, cols, rows))


def test_pass_timer_summary_matches_jax():
    rng = np.random.default_rng(9)
    samples = {"frame": list(rng.uniform(0.01, 0.2, 7)),
               "gbuffer": list(rng.uniform(0.001, 0.01, 3))}
    counters = {"rays": 123456789, "bundles": 77}
    j, t = JPassTimer(enabled=True), PassTimer("cpu")
    for timer in (j, t):
        for name, xs in samples.items():
            timer.samples[name].extend(xs)
        for name, n in counters.items():
            timer.count(name, n // 2)
            timer.count(name, n - n // 2)
    assert t.summary() == j.summary()
    assert t.report() == j.report()
    assert dict(t.counters) == counters
    # without samples no rate is given
    empty = PassTimer("cpu")
    empty.count("rays", 5)
    assert empty.summary() == {"rays": {"count": 5}}


def test_run_interactive_on_a_pty(monkeypatch):
    """Two frames on a pseudo-terminal: each frame writes "w1" into the
    terminal, the loop reads them after the frame, so the second frame's
    camera has moved and DI is toggled; the output holds the half-block
    frames and the status line."""
    master, slave = os.openpty()
    stdin = os.fdopen(slave, "r")
    monkeypatch.setattr(sys, "stdin", stdin)
    cam = tcam.default_camera(window_size=(16, 8))
    g0 = default_gconst(cam.planar_view_constants(), 1)
    seen = []

    def render(g, state):
        seen.append((g.view.camera_direction_or_position.copy(),
                     g.enable_restir_di, g.frame))
        os.write(master, b"w1")
        return state + 1, np.full((8, 16, 3), 0.5, np.float32)

    out = io.StringIO()
    try:
        tviewer.run_interactive(
            render, cam, g0, 0,
            lambda img: (img * 255).astype(np.uint8), max_frames=2, out=out)
    finally:
        stdin.close()
        os.close(master)
    assert [s[2] for s in seen] == [0, 1]
    assert seen[1][0][2] < seen[0][0][2]  # "w" moves against direction
    assert seen[1][1] == 1 - seen[0][1]
    text = out.getvalue()
    assert text.count("\x1b[H") == 2 and "▀" in text
    assert "fps" in text and tviewer.HELP in text
