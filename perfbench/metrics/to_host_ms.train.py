"""to_host_ms.train: the host ms of ``predict``'s copies of the ensemble's
outputs to the host (``pysgmcmc.predict.to_host``), the mean per predict
call (``pysgmcmc.bnn.predict``)."""

from perfbench import program


def read(run):
    return program.host_ms(run, "predict.to_host", per="bnn.predict")
