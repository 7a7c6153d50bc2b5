"""Stochastic Gradient Nosé-Hoover Thermostat (PyTorch port of
:mod:`pysgmcmc_tpu.samplers.sgnht`).

Ding et al., NeurIPS 2014 (Algorithm 2).  A thermostat ``xi`` replaces
SGHMC's fixed friction and adapts so that the kinetic temperature ``p^T p /
d`` stays at 1.  Per step, with stepsize ``eps`` and diffusion ``A``::

    p'     = p - xi eps p - eps grad + sqrt(2 A eps / scale_grad) eta
    theta' = theta + eps p'
    xi'    = xi + eps (p'^T p' / d - 1)

``xi`` is one scalar per chain, starting at ``A``; the momentum starts from
N(0, I) when ``init`` is given a generator, and at zero otherwise.  A state
whose ``xi`` is ``(n_chains,)`` holds ``n_chains`` chains stacked on the
leading axis of every leaf: ``step`` then reduces ``p'^T p'`` per chain and
``d`` counts one chain's parameters.  ``init`` on stacked positions gives a
shared scalar ``xi``, which the lanes driver
(:func:`pysgmcmc_tpu_torch.parallel.packed.sample_chain_lanes`) takes and
returns as ``(n_chains,)``.  This per-step path is the CPU oracle for the
update of kernel B8-sgnht.

Examples
--------
>>> import torch
>>> sampler = SGNHTSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
...                        stepsize_schedule=0.1)
>>> state = sampler.init({"x": torch.zeros(3)}, torch.Generator())
>>> float(state.xi)  # the thermostat starts at the diffusion constant A
1.0
>>> state, info = sampler.step(state, torch.Generator().manual_seed(1))
>>> int(state.step), tuple(state.momentum["x"].shape)
(1, (3,))
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.utils.pytree import (
    normal_like_tree,
    tree_cast,
    tree_map,
    tree_zeros_like,
)


class SGNHTState(NamedTuple):
    position: Any
    momentum: Any
    xi: Any  # the thermostat: a scalar, or one per stacked chain
    step: Any
    schedule_state: Any


class SGNHTSampler(MCMCSampler):
    """SGHMC with a self-adapting Nosé-Hoover friction thermostat.

    Defaults are the JAX package's: constant stepsize 0.01, ``a_diff`` (the
    diffusion constant ``A`` and the thermostat's initial value) 1.0,
    ``scale_grad`` 1.0.  ``gaussian_prior_scale`` ``s > 0`` adds the
    analytic gradient ``s * theta`` of an isotropic Gaussian prior.
    ``noise_bits`` selects a TPU random-bit generator in the JAX package
    and has no counterpart here: anything but ``None`` raises.
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.01,
        a_diff=1.0,
        scale_grad=1.0,
        dtype=torch.float32,
        gaussian_prior_scale=0.0,
        noise_bits=None,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype,
                         gaussian_prior_scale)
        if a_diff <= 0.0:
            raise ValueError("SGNHTSampler: a_diff must be > 0")
        if noise_bits is not None:
            raise NotImplementedError(
                "SGNHTSampler: noise_bits is a TPU bit-generator choice; the "
                "port draws its noise from torch.Generator")
        self.a_diff = float(a_diff)
        self.scale_grad = float(scale_grad)
        self.noise_bits = noise_bits

    def init(self, params, key=None):
        """Initial state for ``params``: momentum N(0, I) drawn from the
        ``torch.Generator`` ``key`` (zeros without one), ``xi = A``."""
        params = tree_cast(params, self.dtype)
        device = next(iter(params.values())).device
        momentum = (normal_like_tree(key, params) if key is not None
                    else tree_zeros_like(params))
        return SGNHTState(
            position=params,
            momentum=momentum,
            xi=torch.full((), self.a_diff, dtype=self.dtype, device=device),
            step=torch.zeros((), dtype=torch.int64, device=device),
            schedule_state=self.stepsize_schedule.init(),
        )

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One SGNHT step.  ``key``, ``noise`` and ``phase`` as in
        :meth:`pysgmcmc_tpu_torch.samplers.psgld.PSGLDSampler.step`."""
        del phase
        eps = self._stepsize(state)
        cost, grads = self._cost_and_grad(state.position, batch)
        if noise is None:
            noise = normal_like_tree(key, state.position)
        sigma = torch.sqrt(2.0 * self.a_diff * eps / torch.as_tensor(
            self.scale_grad, dtype=self.dtype))
        xi = state.xi
        n_axes = xi.ndim  # 1 where the leaves stack chains

        def per_chain(x, leaf):
            return x.reshape(x.shape + (1,) * (leaf.ndim - n_axes))

        momentum = tree_map(
            lambda p, grad, eta: p - per_chain(xi, p) * eps * p - eps * grad
            + sigma * eta,
            state.momentum, grads, noise)
        position = tree_map(lambda theta, p: theta + eps * p, state.position,
                            momentum)
        sumsq = sum(torch.sum(torch.square(p).reshape(xi.shape + (-1,)),
                              dim=-1)
                    for p in momentum.values())
        d = sum(leaf[(0,) * n_axes].numel()
                for leaf in state.position.values())
        new_state = SGNHTState(
            position=position,
            momentum=momentum,
            xi=xi + eps * (sumsq / d - 1.0),
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
