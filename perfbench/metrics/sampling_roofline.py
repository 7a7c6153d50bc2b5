"""sampling_roofline: the least time of the window's SGHMC sampling work
(``perfbench/work/sampling.py``) over the device time of what the
``sample_chain_fused`` calls launched, %."""

from perfbench import readers


def read(run):
    return readers.roofline_share(run, readers.sampling_works(run),
                                  "sample_chain_fused")
