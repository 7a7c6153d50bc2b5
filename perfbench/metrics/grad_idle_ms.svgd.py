"""grad_idle_ms.svgd: the device-idle ms inside the SVGD step's gradient
phase (``pysgmcmc.svgd.gradient``: the stepsize, the vmapped
``grad_and_value`` and the ravels), the mean per step
(``pysgmcmc.svgd.step``)."""

from perfbench import program


def read(run):
    return program.idle_ms(run, "svgd.gradient", per="svgd.step")
