"""readback_wait_ms: host-clock ms a window frame spent inside the
program's readback.* spans, the host blocked in a device-to-host read
while the queue ahead of it drains."""

from portbench import program

UNIT = "ms"


def install(run):
    program.install(run)


def read(run):
    return program.host_ms(run, "readback.")
