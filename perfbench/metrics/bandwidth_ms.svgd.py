"""bandwidth_ms.svgd: the device ms of the operations launched inside the
SVGD step's bandwidth phase (``pysgmcmc.svgd.bandwidth``: the subsample,
the squared distances' Gram product and the median's sort), the mean per
step (``pysgmcmc.svgd.step``)."""

from perfbench import program


def read(run):
    return program.device_ms(run, "svgd.bandwidth", per="svgd.step")
