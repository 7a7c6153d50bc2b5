"""burnin_roofline: the least time of the window's SGHMC burn-in work
(``perfbench/work/burnin.py``) over the device time of what the
``burnin_chain_fused`` calls launched, %."""

from perfbench import readers


def read(run):
    return readers.roofline_share(run, readers.burnin_works(run),
                                  "burnin_chain_fused")
