"""update_idle_ms.svgd: the device-idle ms inside the SVGD step's update
phase (``pysgmcmc.svgd.update``: the accumulator's ravel, Adagrad, the
unravels and the new state), the mean per step (``pysgmcmc.svgd.step``)."""

from perfbench import program


def read(run):
    return program.idle_ms(run, "svgd.update", per="svgd.step")
