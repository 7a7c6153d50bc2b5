"""Functional sampler contract (PyTorch port of :mod:`pysgmcmc_tpu.samplers.base`).

A sampler is a pair of functions over an explicit state::

    state       = sampler.init(params)
    state, info = sampler.step(state, generator, batch)

``params`` is a dict of tensors.  Gradients come from
``torch.autograd.grad`` on ``cost_fn``; randomness comes from an explicit
``torch.Generator``.  ``sample_chain``, the thinning scan and the iterator
facade are not ported yet (``ROADMAP.md`` queue A).
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.stepsize_schedules import (
    ConstantStepsizeSchedule,
    StepsizeSchedule,
)


class SamplerInfo(NamedTuple):
    """Per-step auxiliary outputs (cost value and the stepsize used)."""

    cost: Any
    stepsize: Any


class MCMCSampler:
    """Base class for functional SG-MCMC samplers.

    ``cost_fn(params)`` or ``cost_fn(params, batch)`` returns a scalar
    tensor; ``stepsize_schedule`` is a :class:`StepsizeSchedule` or a float;
    ``dtype`` is the element type of the sampler state;
    ``gaussian_prior_scale`` ``s > 0`` adds the analytic gradient ``s *
    theta`` of an isotropic Gaussian prior to every gradient.
    """

    def __init__(self, cost_fn, stepsize_schedule=0.01, dtype=torch.float32,
                 gaussian_prior_scale=0.0):
        if not callable(cost_fn):
            raise ValueError(
                "MCMCSampler: `cost_fn` must be callable, got {!r}".format(cost_fn)
            )
        if not isinstance(stepsize_schedule, StepsizeSchedule):
            stepsize_schedule = ConstantStepsizeSchedule(float(stepsize_schedule))
        self.cost_fn = cost_fn
        self.stepsize_schedule = stepsize_schedule
        self.dtype = dtype
        self.gaussian_prior_scale = float(gaussian_prior_scale)

    def init(self, params, key=None):
        raise NotImplementedError

    def step(self, state, key, batch=None, phase=None):
        raise NotImplementedError

    @staticmethod
    def position(state):
        """Extract the current sample (the target parameters) from a state."""
        return state.position

    def _cost_and_grad(self, params, batch):
        """Cost and its gradient with respect to every leaf of ``params``,
        the Gaussian prior's ``gaussian_prior_scale * theta`` included."""
        names = list(params)
        with torch.enable_grad():
            leaves = [params[n].detach().requires_grad_(True) for n in names]
            tracked = dict(zip(names, leaves))
            cost = (self.cost_fn(tracked) if batch is None
                    else self.cost_fn(tracked, batch))
            grads = torch.autograd.grad(cost, leaves)
        scale = self.gaussian_prior_scale
        if scale:
            grads = [g + scale * params[n] for n, g in zip(names, grads)]
        return cost.detach(), dict(zip(names, grads))

    def _stepsize(self, state):
        eps = self.stepsize_schedule.value(state.schedule_state, state.step)
        return torch.as_tensor(eps, dtype=self.dtype)
