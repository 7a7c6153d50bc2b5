"""prologue_idle_ms.train: the device-idle ms of each burn-in chunk
(``pysgmcmc.fused.burn_in`` inside the model's ``pysgmcmc.bnn.burn_in``)
from its start to the launch of its burn-in kernel (pack, casts, the data
windows, the step read and the seed draw, the chunk's ε table and the kernel
wrapper's checks), the mean per chunk."""

from perfbench import program


def read(run):
    return program.prologue_idle_ms(run, "fused.burn_in",
                                    within="bnn.burn_in")
