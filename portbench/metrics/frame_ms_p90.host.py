"""frame_ms_p90.host: the nearest-rank 90th percentile of the frame times
of a traced run's window (host clock, each frame from its render_frame
call to its synchronised end), the profiled frames left out. Where the
device idles most of a frame, the frame's tail is the host's."""

from portbench import stats

UNIT = "ms"


def read(run):
    times = [s for k, s in enumerate(run.frame_s) if k not in run.profiled]
    return stats.percentile(times, 90) * 1e3 if times else None
