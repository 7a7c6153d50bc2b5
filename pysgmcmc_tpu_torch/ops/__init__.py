from pysgmcmc_tpu_torch.ops.fused_step import (
    FusedLayout,
    data_windows,
    fused_bnn_multistep,
    fused_bnn_multistep_burnin,
    fused_bnn_multistep_burnin_ref,
    fused_bnn_multistep_ref,
    fused_layout,
    pack,
    unpack,
)

__all__ = [
    "FusedLayout",
    "data_windows",
    "fused_bnn_multistep",
    "fused_bnn_multistep_burnin",
    "fused_bnn_multistep_burnin_ref",
    "fused_bnn_multistep_ref",
    "fused_layout",
    "pack",
    "unpack",
]
