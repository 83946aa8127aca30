"""device_idle_pct: 100 x (1 - the union of the device's operation
intervals / the wall time of the profiled frames)."""

from portbench import stats

UNIT = "%"


def read(run):
    if not run.profile or not run.profile["kernels"]:
        return None
    busy = stats.union_busy([(a, b) for _, a, b in run.profile["kernels"]])
    return 100.0 * (1.0 - busy * 1e-9 / run.counters["profiled_window_s"])
