from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.samplers.sghmc import SGHMCSampler, SGHMCState

__all__ = [
    "AdaptiveStats",
    "MCMCSampler",
    "SamplerInfo",
    "SGHMCSampler",
    "SGHMCState",
]
