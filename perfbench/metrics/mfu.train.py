"""mfu.train: the network's products of the window's trains (burn-in and
sampling chain-steps, and the predict calls' forward passes) over the
window at the TF32 peak, %."""

from perfbench import readers


def read(run):
    return readers.mfu(run, readers.burnin_works(run)
                       + readers.sampling_works(run)
                       + readers.predict_works(run))
