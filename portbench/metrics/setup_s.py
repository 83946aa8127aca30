"""setup_s: process start to the window's start (the program's library,
the scene, build_scene, create_renderer and the warm-up frames)."""

UNIT = "s"


def read(run):
    return run.setup_s
