"""frame_ms: the window's wall time over the frames completed in it (host
clock; the window ends at the end of a whole frame)."""

from portbench import stats

UNIT = "ms"


def read(run):
    return stats.window_mean_ms(run.window_s, run.frames)
