"""Relativistic Stochastic Gradient Hamiltonian Monte Carlo (PyTorch port of
:mod:`pysgmcmc_tpu.samplers.relativistic_sghmc`).

Lu et al., "Relativistic Monte Carlo", AISTATS 2017: the momentum's
magnitude is bounded by the "speed of light" ``c``.  Per step, with the
gradient of the log-likelihood ``-(grad + prior_scale theta)``::

    v(p)   = eps p / (m sqrt(p^2 / (m^2 c^2) + 1))
    p'     = p + eps grad_loglik + sqrt(eps (2 D - eps Bhat)) eta - D v(p)
    theta' = theta + v(p')

The initial momentum is drawn elementwise from the relativistic marginal
(:mod:`pysgmcmc_tpu_torch.ops.relativistic`).  The sampler has no
``scale_grad``.  This per-step path is the CPU oracle for the update of
kernel B8-rsghmc.

Examples
--------
>>> import torch
>>> sampler = RelativisticSGHMCSampler(
...     lambda p: 0.5 * torch.sum(p["x"] ** 2), stepsize_schedule=0.001)
>>> state = sampler.init({"x": torch.zeros(2)}, torch.Generator())
>>> state, info = sampler.step(state, torch.Generator().manual_seed(1))
>>> state.momentum["x"].shape
torch.Size([2])
>>> bool(torch.isfinite(state.position["x"]).all())
True
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.ops.relativistic import (
    sample_relativistic_momentum_tree,
)
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.utils.pytree import normal_like_tree, tree_cast, tree_map


class RelativisticSGHMCState(NamedTuple):
    position: Any
    momentum: Any
    step: Any
    schedule_state: Any


class RelativisticSGHMCSampler(MCMCSampler):
    """Relativistic SGHMC.

    Defaults are the reference's: constant stepsize 0.001, ``mass`` 1.0,
    ``speed_of_light`` 1.0, ``D`` (diffusion and friction) 1.0, ``Bhat``
    (the gradient-noise variance estimate) 0.0.  ``gaussian_prior_scale``
    ``s > 0`` adds the analytic gradient ``s * theta`` of an isotropic
    Gaussian prior to the cost's gradient.
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.001,
        mass=1.0,
        speed_of_light=1.0,
        D=1.0,
        Bhat=0.0,
        dtype=torch.float32,
        gaussian_prior_scale=0.0,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype,
                         gaussian_prior_scale)
        self.mass = float(mass)
        self.speed_of_light = float(speed_of_light)
        self.D = float(D)
        self.Bhat = float(Bhat)

    def _velocity(self, p, eps):
        """``eps p / (m sqrt(p^2 / (m^2 c^2) + 1))``."""
        m, c = self.mass, self.speed_of_light
        return eps * p / (m * torch.sqrt(p * p / (m**2 * c**2) + 1.0))

    def init(self, params, key=None):
        """Initial state for ``params``: the momentum drawn from the
        relativistic marginal with the ``torch.Generator`` ``key`` (a
        generator seeded with 0 without one)."""
        params = tree_cast(params, self.dtype)
        device = next(iter(params.values())).device
        if key is None:
            key = torch.Generator().manual_seed(0)
        return RelativisticSGHMCState(
            position=params,
            momentum=sample_relativistic_momentum_tree(
                key, params, m=self.mass, c=self.speed_of_light),
            step=torch.zeros((), dtype=torch.int64, device=device),
            schedule_state=self.stepsize_schedule.init(),
        )

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One relativistic SGHMC step.  ``key``, ``noise`` and ``phase`` as
        in :meth:`pysgmcmc_tpu_torch.samplers.psgld.PSGLDSampler.step`."""
        del phase
        eps = self._stepsize(state)
        cost, grads = self._cost_and_grad(state.position, batch)
        if noise is None:
            noise = normal_like_tree(key, state.position)
        noise_scale = torch.sqrt(eps * (2.0 * self.D - eps * self.Bhat))

        # the dynamics use the log-likelihood gradient, -grads
        momentum = tree_map(
            lambda p, grad, eta: p + eps * -grad + noise_scale * eta
            - self.D * self._velocity(p, eps),
            state.momentum, grads, noise)
        position = tree_map(
            lambda theta, p: theta + self._velocity(p, eps), state.position,
            momentum)
        new_state = RelativisticSGHMCState(
            position=position,
            momentum=momentum,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
