"""mfu.sample: the network's products of the window's sampling
chain-steps over the window at the TF32 peak, %."""

from perfbench import readers


def read(run):
    return readers.mfu(run, readers.sampling_works(run))
