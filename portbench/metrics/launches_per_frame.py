"""launches_per_frame: device kernels in the profiled frames (memory
copies and fills left out) over their count."""

UNIT = "launches"


def read(run):
    if not run.profile or not len(run.profiled):
        return None
    n = sum(1 for name, _, _ in run.profile["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(run.profiled)
