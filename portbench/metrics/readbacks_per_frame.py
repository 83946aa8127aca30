"""readbacks_per_frame: the device-to-host reads the program made in the
window's frames (its "readback" counter, utils/readback.py: each read
waits for the device to drain the work queued before it), over the
frames."""

from portbench import program

UNIT = "reads"


def install(run):
    program.install(run)


def read(run):
    return program.count_per_frame(run, "readback")
