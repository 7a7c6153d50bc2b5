from pysgmcmc_tpu_torch.diagnostics import objective_functions

__all__ = ["objective_functions"]
