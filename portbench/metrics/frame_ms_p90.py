"""frame_ms_p90: the nearest-rank 90th percentile of the window's frame
times, each from its render_frame call to its synchronised end (host
clock)."""

from portbench import stats

UNIT = "ms"


def read(run):
    return stats.percentile(run.frame_s, 90) * 1e3
