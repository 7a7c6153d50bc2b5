"""Stochastic Gradient Hamiltonian Monte Carlo with scale-adapted burn-in
(PyTorch port of :mod:`pysgmcmc_tpu.samplers.sghmc`).

Per-step update (reference ``sghmc.py:109-253``)::

    eps_scaled = eps / sqrt(scale_grad)
    sigma      = sqrt(max(2 * eps_scaled**2 * mdecay * minv - eps_scaled**4, 1e-16))
    v_new      = v - eps**2 * minv * grad - mdecay * v + sigma * N(0, 1)
    theta_new  = theta + v_new

The gradient term uses the unscaled stepsize squared while the noise uses
``eps_scaled``: the reference's asymmetry is kept.  This per-step path is
the CPU oracle for the fused kernels' update math
(:mod:`pysgmcmc_tpu_torch.ops.fused_step`).

Examples
--------
>>> import torch
>>> sampler = SGHMCSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
...                        stepsize_schedule=0.1, burn_in_steps=2)
>>> state = sampler.init({"x": torch.ones(1)})
>>> state, info = sampler.step(state, torch.Generator().manual_seed(0))
>>> (int(state.step), round(float(info.stepsize), 3))
(1, 0.1)
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.samplers._adaptive import (
    AdaptiveStats,
    init_stats,
    update_stats,
)
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.utils.pytree import (
    normal_like_tree,
    tree_cast,
    tree_map,
    tree_zeros_like,
)


class SGHMCState(NamedTuple):
    position: Any
    momentum: Any
    stats: AdaptiveStats
    step: Any
    schedule_state: Any


class SGHMCSampler(MCMCSampler):
    """SGHMC with self-tuning diagonal mass matrix.

    Defaults match the reference: constant stepsize 0.01, ``burn_in_steps``
    3000, ``mdecay`` 0.05, ``scale_grad`` 1.0.  ``gaussian_prior_scale``
    ``s > 0`` adds the analytic gradient ``s * theta`` of an isotropic
    Gaussian prior.  ``noise_bits`` selects a TPU random-bit generator in the
    JAX package and has no counterpart here: anything but ``None`` raises.
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.01,
        burn_in_steps=3000,
        mdecay=0.05,
        scale_grad=1.0,
        dtype=torch.float32,
        gaussian_prior_scale=0.0,
        noise_bits=None,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype,
                         gaussian_prior_scale)
        if burn_in_steps < 0:
            raise ValueError("SGHMCSampler: burn_in_steps must be >= 0")
        if noise_bits is not None:
            raise NotImplementedError(
                "SGHMCSampler: noise_bits is a TPU bit-generator choice; the "
                "port draws its noise from torch.Generator")
        self.burn_in_steps = int(burn_in_steps)
        self.mdecay = float(mdecay)
        self.scale_grad = float(scale_grad)
        self.noise_bits = noise_bits

    def init(self, params, key=None):
        """Initial state for ``params`` (a dict of tensors, optionally with a
        leading chain axis: the state then holds every chain, sharing
        one step counter)."""
        params = tree_cast(params, self.dtype)
        device = next(iter(params.values())).device
        return SGHMCState(
            position=params,
            momentum=tree_zeros_like(params),
            stats=init_stats(params),
            step=torch.zeros((), dtype=torch.int64, device=device),
            schedule_state=self.stepsize_schedule.init(),
        )

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One SGHMC step.

        ``key`` is the ``torch.Generator`` the noise is drawn from, unless
        ``noise`` (a dict shaped like the position) injects it.  ``phase``
        (``"burn_in"`` / ``"sampling"`` / ``None``) fixes the side of the
        burn-in boundary as in :func:`update_stats`.
        """
        eps = self._stepsize(state)
        eps_scaled = eps / torch.sqrt(
            torch.as_tensor(self.scale_grad, dtype=self.dtype))
        cost, grads = self._cost_and_grad(state.position, batch)

        burning_in = state.step < self.burn_in_steps
        stats, minv = update_stats(state.stats, grads, burning_in, phase)

        if noise is None:
            noise = normal_like_tree(key, state.position)

        def momentum_leaf(v, grad, minv_leaf, eta):
            noise_var = (
                2.0 * eps_scaled**2 * self.mdecay * minv_leaf - eps_scaled**4
            )
            sigma = torch.sqrt(torch.clamp(noise_var, min=1e-16))
            return v - eps**2 * minv_leaf * grad - self.mdecay * v + sigma * eta

        momentum = tree_map(momentum_leaf, state.momentum, grads, minv, noise)
        position = tree_map(lambda theta, v: theta + v, state.position,
                            momentum)
        new_state = SGHMCState(
            position=position,
            momentum=momentum,
            stats=stats,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
