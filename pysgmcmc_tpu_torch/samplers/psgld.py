"""Preconditioned SGLD (pSGLD), RMSprop-adaptive Langevin dynamics (PyTorch
port of :mod:`pysgmcmc_tpu.samplers.psgld`).

Li, Chen, Carlson & Carin, AAAI 2016.  A diagonal RMSprop preconditioner
adapts every step; there is no burn-in phase and nothing freezes::

    v_t   = alpha v_{t-1} + (1 - alpha) grad^2
    G_t   = 1 / (lambda + sqrt(v_t))
    theta = theta - (eps / 2) G_t grad + N(0, eps G_t / scale_grad)

``scale_grad`` scales the noise as in :mod:`pysgmcmc_tpu_torch.samplers.
sgld`.  This per-step path is the CPU oracle for the update of kernel
B8-psgld (:func:`pysgmcmc_tpu_torch.ops.slim_update.slim_psgld_update`).

Examples
--------
>>> import torch
>>> sampler = PSGLDSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
...                        stepsize_schedule=0.01)
>>> state = sampler.init({"x": torch.zeros(2)})
>>> state, info = sampler.step(state, torch.Generator().manual_seed(0))
>>> int(state.step)
1
>>> bool((state.v["x"] >= 0).all())  # RMSprop accumulator
True
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.utils.numeric import safe_sqrt
from pysgmcmc_tpu_torch.utils.pytree import (
    normal_like_tree,
    tree_cast,
    tree_map,
    tree_zeros_like,
)


class PSGLDState(NamedTuple):
    position: Any
    v: Any  # RMSprop second-moment accumulator
    step: Any
    schedule_state: Any


class PSGLDSampler(MCMCSampler):
    """RMSprop-preconditioned SGLD.

    Defaults are the JAX package's: constant stepsize 0.001, ``alpha``
    (second-moment decay) 0.99, ``lambda_reg`` (preconditioner
    regulariser) 1e-5, ``scale_grad`` 1.0.  ``gaussian_prior_scale`` ``s >
    0`` adds the analytic gradient ``s * theta`` of an isotropic Gaussian
    prior.
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.001,
        alpha=0.99,
        lambda_reg=1e-5,
        scale_grad=1.0,
        dtype=torch.float32,
        gaussian_prior_scale=0.0,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype,
                         gaussian_prior_scale)
        if not 0.0 <= alpha < 1.0:
            raise ValueError("PSGLDSampler: alpha must be in [0, 1)")
        self.alpha = float(alpha)
        self.lambda_reg = float(lambda_reg)
        self.scale_grad = float(scale_grad)

    def init(self, params, key=None):
        """Initial state for ``params`` (a dict of tensors, optionally with a
        leading chain axis: the state then holds every chain, sharing one
        step counter); the accumulator starts at zero."""
        params = tree_cast(params, self.dtype)
        device = next(iter(params.values())).device
        return PSGLDState(
            position=params,
            v=tree_zeros_like(params),
            step=torch.zeros((), dtype=torch.int64, device=device),
            schedule_state=self.stepsize_schedule.init(),
        )

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One pSGLD step.  ``key`` is the ``torch.Generator`` the noise is
        drawn from unless ``noise`` injects it; ``phase`` is accepted for
        driver uniformity and ignored (the preconditioner adapts every
        step)."""
        del phase
        eps = self._stepsize(state)
        cost, grads = self._cost_and_grad(state.position, batch)
        if noise is None:
            noise = normal_like_tree(key, state.position)

        v_new = tree_map(
            lambda v, grad: self.alpha * v + (1.0 - self.alpha) * grad * grad,
            state.v, grads)

        def update_leaf(theta, v, grad, eta):
            precond = 1.0 / (self.lambda_reg + safe_sqrt(v))
            sigma = safe_sqrt(eps * precond / self.scale_grad)
            return theta - 0.5 * eps * precond * grad + sigma * eta

        position = tree_map(update_leaf, state.position, v_new, grads, noise)
        new_state = PSGLDState(
            position=position,
            v=v_new,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
