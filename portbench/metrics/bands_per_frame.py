"""bands_per_frame: the row bands the program's per-pixel passes ran in
(its "band" counter, render/banding.py::banded: one a band, where a
launch is over the pass's lane threshold), over the window's frames.
None where the program has no such counter (a tree before it)."""

from portbench import program

UNIT = "bands"


def install(run):
    program.install(run)


def read(run):
    return program.count_per_frame(run, "band")
