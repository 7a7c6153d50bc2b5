from pysgmcmc_tpu_torch.parallel.packed import (
    LanesSpec,
    burnin_chain_fused,
    burnin_chain_lanes,
    make_lanes_spec,
    pack_lanes,
    resolve_noise_impl,
    sample_chain_fused,
    sample_chain_lanes,
    unpack_lanes,
)

__all__ = [
    "LanesSpec",
    "burnin_chain_fused",
    "burnin_chain_lanes",
    "make_lanes_spec",
    "pack_lanes",
    "resolve_noise_impl",
    "sample_chain_fused",
    "sample_chain_lanes",
    "unpack_lanes",
]
