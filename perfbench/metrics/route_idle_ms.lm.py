"""route_idle_ms.lm: the device-idle ms inside the program's ``moe.route``
spans (the scores, top-k, sort and gather of both passes, with the wait
for the tokens per expert on the host), the mean per step
(``pysgmcmc.lanes.gradient``)."""

from perfbench import program


def read(run):
    return program.idle_ms(run, "moe.route", per="lanes.gradient")
