"""prologue_idle_ms.sample: the device-idle ms of each sampling call
(``pysgmcmc.fused.sample``) from its start to the launch of its first fused
kernel (pack, casts, the data windows, the seed draw and the step read, the
first launch's ε table and the kernel wrapper's checks), the mean per
call."""

from perfbench import program


def read(run):
    return program.prologue_idle_ms(run, "fused.sample")
