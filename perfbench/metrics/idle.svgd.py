"""idle.svgd: the share of the traced window in which no device operation
ran, %."""

from perfbench import readers


def read(run):
    return readers.idle_share(run)
