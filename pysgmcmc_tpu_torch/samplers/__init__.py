from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.samplers.sghmc import SGHMCSampler, SGHMCState
from pysgmcmc_tpu_torch.samplers.sgld import SGLDSampler, SGLDState

__all__ = [
    "AdaptiveStats",
    "MCMCSampler",
    "SamplerInfo",
    "SGHMCSampler",
    "SGHMCState",
    "SGLDSampler",
    "SGLDState",
]
