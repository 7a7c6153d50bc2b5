from pysgmcmc_tpu_torch.parallel.packed import (
    burnin_chain_fused,
    resolve_noise_impl,
    sample_chain_fused,
)

__all__ = ["burnin_chain_fused", "resolve_noise_impl", "sample_chain_fused"]
