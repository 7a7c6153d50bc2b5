"""Stochastic Gradient Langevin Dynamics with scale-adapted burn-in
(PyTorch port of :mod:`pysgmcmc_tpu.samplers.sgld`).

Welling & Teh (ICML 2011) preconditioned by the Springenberg et al. (NIPS
2016) burn-in adaptation of :mod:`pysgmcmc_tpu_torch.samplers._adaptive`.
Per-step update (reference ``sgld.py:183-204``, noise constant 0)::

    sigma     = sqrt(2 * eps * minv * A / scale_grad)
    theta_new = theta - eps * minv * A * grad + sigma * N(0, 1)

The noise scales with ``eps``, not with SGHMC's ``eps**2``.  This per-step
path is the CPU oracle for the SGLD update of the fused kernels
(:mod:`pysgmcmc_tpu_torch.ops.fused_step`).

Examples
--------
>>> import torch
>>> sampler = SGLDSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
...                       stepsize_schedule=0.05, burn_in_steps=1)
>>> state = sampler.init({"x": torch.zeros(3)})
>>> state, info = sampler.step(state, torch.Generator().manual_seed(0))
>>> (int(state.step), tuple(state.position["x"].shape))
(1, (3,))
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.samplers._adaptive import (
    AdaptiveStats,
    init_stats,
    update_stats,
)
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.utils.numeric import safe_divide, safe_sqrt
from pysgmcmc_tpu_torch.utils.pytree import normal_like_tree, tree_cast, tree_map


class SGLDState(NamedTuple):
    position: Any
    stats: AdaptiveStats
    step: Any
    schedule_state: Any


class SGLDSampler(MCMCSampler):
    """SGLD with self-tuning diagonal preconditioner.

    Defaults match the reference: constant stepsize 0.01, ``burn_in_steps``
    3000, ``A`` 1.0, ``scale_grad`` 1.0.  ``gaussian_prior_scale`` ``s > 0``
    adds the analytic gradient ``s * theta`` of an isotropic Gaussian
    prior.  ``noise_bits`` selects a TPU random-bit generator in the JAX
    package and has no counterpart here: anything but ``None`` raises.
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.01,
        burn_in_steps=3000,
        A=1.0,
        scale_grad=1.0,
        dtype=torch.float32,
        gaussian_prior_scale=0.0,
        noise_bits=None,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype,
                         gaussian_prior_scale)
        if burn_in_steps < 0:
            raise ValueError("SGLDSampler: burn_in_steps must be >= 0")
        if noise_bits is not None:
            raise NotImplementedError(
                "SGLDSampler: noise_bits is a TPU bit-generator choice; the "
                "port draws its noise from torch.Generator")
        self.burn_in_steps = int(burn_in_steps)
        self.A = float(A)
        self.scale_grad = float(scale_grad)
        self.noise_bits = noise_bits

    def init(self, params, key=None):
        """Initial state for ``params`` (a dict of tensors, optionally with a
        leading chain axis: the state then holds every chain, sharing one
        step counter)."""
        params = tree_cast(params, self.dtype)
        device = next(iter(params.values())).device
        return SGLDState(
            position=params,
            stats=init_stats(params),
            step=torch.zeros((), dtype=torch.int64, device=device),
            schedule_state=self.stepsize_schedule.init(),
        )

    def partition_frozen(self, state, phase=None):
        """Post-burn-in, the adaptation stats are loop invariants."""
        if phase != "sampling":
            return state, None
        return state._replace(stats=None), state.stats

    @staticmethod
    def merge_frozen(dynamic, frozen):
        if frozen is None:
            return dynamic
        return dynamic._replace(stats=frozen)

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One SGLD step.  ``key``, ``noise`` and ``phase`` as in
        :meth:`pysgmcmc_tpu_torch.samplers.sghmc.SGHMCSampler.step`."""
        eps = self._stepsize(state)
        cost, grads = self._cost_and_grad(state.position, batch)

        burning_in = state.step < self.burn_in_steps
        stats, minv = update_stats(state.stats, grads, burning_in, phase)

        if noise is None:
            noise = normal_like_tree(key, state.position)

        def update_leaf(theta, grad, minv_leaf, eta):
            sigma = safe_sqrt(
                2.0 * eps * safe_divide(minv_leaf * self.A, self.scale_grad))
            return theta - eps * minv_leaf * self.A * grad + sigma * eta

        position = tree_map(update_leaf, state.position, grads, minv, noise)
        new_state = SGLDState(
            position=position,
            stats=stats,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
