"""pysgmcmc_tpu_torch — the PyTorch and CUDA port of :mod:`pysgmcmc_tpu`.

It runs the fused path of the JAX package on an NVIDIA H100: SGHMC or SGLD
over the dense tanh heteroscedastic BNN (``BayesianNeuralNetwork(
network="dense", step_impl="fused")``), with burn-in, sampling and the
one-step driver in hand-written CUDA kernels (``csrc/fused_step.cu``) and a
plain PyTorch version of each kernel for CPU tensors.  Module paths mirror the JAX package's.  It imports torch,
never jax; the JAX package stays the reference the tests hold it against.
"""

__version__ = "0.1.0"

from pysgmcmc_tpu_torch import (
    diagnostics,
    interop,
    models,
    ops,
    parallel,
    samplers,
    stepsize_schedules,
    utils,
)
from pysgmcmc_tpu_torch.sampling import Sampler

__all__ = [
    "Sampler",
    "diagnostics",
    "interop",
    "models",
    "ops",
    "parallel",
    "samplers",
    "stepsize_schedules",
    "utils",
]
