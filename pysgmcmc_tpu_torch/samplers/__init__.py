from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.samplers.fused import FusedSGHMC, FusedSGHMCState
from pysgmcmc_tpu_torch.samplers.psgld import PSGLDSampler, PSGLDState
from pysgmcmc_tpu_torch.samplers.relativistic_sghmc import (
    RelativisticSGHMCSampler,
    RelativisticSGHMCState,
)
from pysgmcmc_tpu_torch.samplers.sghmc import SGHMCSampler, SGHMCState
from pysgmcmc_tpu_torch.samplers.sgld import SGLDSampler, SGLDState
from pysgmcmc_tpu_torch.samplers.sgnht import SGNHTSampler, SGNHTState
from pysgmcmc_tpu_torch.samplers.svgd import SVGDSampler, SVGDState

__all__ = [
    "AdaptiveStats",
    "FusedSGHMC",
    "FusedSGHMCState",
    "MCMCSampler",
    "PSGLDSampler",
    "PSGLDState",
    "RelativisticSGHMCSampler",
    "RelativisticSGHMCState",
    "SamplerInfo",
    "SGHMCSampler",
    "SGHMCState",
    "SGLDSampler",
    "SGLDState",
    "SGNHTSampler",
    "SGNHTState",
    "SVGDSampler",
    "SVGDState",
]
