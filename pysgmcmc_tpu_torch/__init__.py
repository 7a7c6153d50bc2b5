"""pysgmcmc_tpu_torch — the PyTorch and CUDA port of :mod:`pysgmcmc_tpu`.

It runs the JAX package's BNN on an NVIDIA H100: the fused path
(``BayesianNeuralNetwork(network="dense", step_impl="fused")``, burn-in,
sampling and the one-step driver in ``csrc/fused_step.cu``) and the
chains-on-lanes path (``step_impl="lanes"``, ``csrc/slim_update.cu``) with
the five gradient samplers, and SVGD's particle ensemble
(``sampling_method=Sampler.SVGD``, the transport in
``csrc/svgd_streaming.cu``), all in hand-written CUDA kernels with a plain
PyTorch version of each for CPU tensors.  Module paths mirror the JAX
package's.  It imports torch, never jax; the JAX package stays the
reference the tests hold it against.
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
