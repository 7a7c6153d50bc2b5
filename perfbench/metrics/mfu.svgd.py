"""mfu.svgd: every window step's gradient products of all particles and the
transport's products over the window at the TF32 peak, %."""

from perfbench import readers


def read(run):
    return readers.mfu(run, readers.svgd_works(run))
