"""Stein Variational Gradient Descent over a particle ensemble (PyTorch port
of :mod:`pysgmcmc_tpu.samplers.svgd`).

After Liu & Wang, NIPS 2016.  The ensemble is a dict of tensors with a
leading ``(n_particles, ...)`` axis; every particle's cost and gradient come
from one ``torch.func.vmap(grad_and_value(cost_fn))`` with the minibatch
shared by all particles (JAX's ``in_axes=(0, None)``).  The kernel geometry
is computed on per-particle raveled vectors.  Update (Adagrad-scaled)::

    phi_i  = (1/n) * (sum_j K_ji * grad_logp(x_j) + sum_j grad_{x_j} K_ji)
    hist   = alpha * hist + (1 - alpha) * phi^2
    x_i   += eps * phi_i / (fudge + sqrt(hist))

``cost_fn`` is a negative log likelihood, so ``grad_logp = -grad cost``; the
repulsion has Liu & Wang's sign (particles repel), as in the JAX package
and not as in the reference, whose repulsion attracts.

``kernel_impl="dense"`` materialises the RBF kernel matrix
(:func:`pysgmcmc_tpu_torch.ops.pairwise.svgd_kernel`, ``torch.matmul``);
``"streaming"`` runs kernel B11
(:func:`pysgmcmc_tpu_torch.ops.svgd_streaming.svgd_phi_streaming`), memory
O(n d), with the median bandwidth of all particles up to
``bandwidth_subsample`` of them and beyond that of a uniform subsample
drawn each step from the step's generator (the JAX package folds the step
key; the streams differ).

Spans (:mod:`pysgmcmc_tpu_torch.utils.tracing`, recorded only while a
profiler records): ``svgd.step`` holds, one after another,
``svgd.gradient`` (the stepsize, the vmapped gradient and the ravels),
``svgd.bandwidth`` (streaming only: the subsample, the squared distances
and the median), ``svgd.transport`` (B11, or the dense kernel and its
product) and ``svgd.update`` (Adagrad and the new state).

Examples
--------
>>> import torch
>>> sampler = SVGDSampler(lambda x: 0.5 * torch.sum(x["x"] ** 2))
>>> particles = {"x": torch.randn(8, 2, generator=torch.Generator(
...     ).manual_seed(0))}
>>> state = sampler.init(particles)
>>> state, info = sampler.step(state, torch.Generator().manual_seed(1))
>>> tuple(state.position["x"].shape)
(8, 2)
>>> tuple(info.cost.shape)  # one cost per particle
(8,)
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.ops.pairwise import (
    median_bandwidth,
    squared_distance_matrix,
    svgd_kernel,
)
from pysgmcmc_tpu_torch.ops.svgd_streaming import svgd_phi_streaming
from pysgmcmc_tpu_torch.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu_torch.utils.pytree import tree_cast, tree_zeros_like
from pysgmcmc_tpu_torch.utils.tracing import span, spanned


class SVGDState(NamedTuple):
    position: Any  # dict of tensors, leading particle axis
    historical_grad: Any  # same structure, Adagrad accumulator
    step: Any
    schedule_state: Any


def _ravel_particles(particles):
    """``(n, ...)`` dict -> ``(n, total_dim)`` matrix (leaves in the dict's
    order) and the function that unravels such a matrix."""
    names = list(particles)
    shapes = [tuple(particles[name].shape) for name in names]
    n = shapes[0][0]
    flat = torch.cat([particles[name].reshape(n, -1) for name in names],
                     dim=1)

    def unravel(matrix):
        out, offset = {}, 0
        for name, shape in zip(names, shapes):
            size = 1
            for dim in shape[1:]:
                size *= dim
            out[name] = matrix[:, offset:offset + size].reshape(shape)
            offset += size
        return out

    return flat, unravel


class SVGDSampler(MCMCSampler):
    """SVGD with an RBF kernel, the median bandwidth and Adagrad stepsizes.

    Parameters and defaults are the JAX package's (the reference's, for the
    first three): ``stepsize_schedule`` constant 0.1, ``alpha`` (Adagrad
    decay) 0.9, ``fudge_factor`` (Adagrad epsilon) 1e-6, ``kernel_impl``
    ``"dense"`` or ``"streaming"``, ``bandwidth_subsample`` 4096,
    ``streaming_tile`` 512 (the plain version's column chunk; the kernel's
    tiles are its own) and ``streaming_interpret`` (the plain version,
    which runs on CPU tensors only: on CUDA tensors it raises).  ``cost_fn``
    takes a single particle (optionally with a batch) and is vmapped over
    the ensemble.
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.1,
        alpha=0.9,
        fudge_factor=1e-6,
        dtype=torch.float32,
        kernel_impl="dense",
        bandwidth_subsample=4096,
        streaming_tile=512,
        streaming_interpret=False,
    ):
        if not isinstance(alpha, (int, float)):
            raise ValueError("SVGDSampler: alpha must be a number")
        if not isinstance(fudge_factor, (int, float)):
            raise ValueError("SVGDSampler: fudge_factor must be a number")
        if kernel_impl not in ("dense", "streaming"):
            raise ValueError(
                "SVGDSampler: kernel_impl must be 'dense' or 'streaming'"
            )
        super().__init__(cost_fn, stepsize_schedule, dtype)
        self.alpha = float(alpha)
        self.fudge_factor = float(fudge_factor)
        self.kernel_impl = kernel_impl
        self.bandwidth_subsample = int(bandwidth_subsample)
        self.streaming_tile = int(streaming_tile)
        self.streaming_interpret = bool(streaming_interpret)

    def init(self, particles, key=None):
        """Initial state of ``particles``: a dict of tensors with a leading
        particle axis, or a list of single-particle dicts (stacked)."""
        if isinstance(particles, (list, tuple)):
            particles = {name: torch.stack([p[name] for p in particles])
                         for name in particles[0]}
        particles = tree_cast(particles, self.dtype)
        device = next(iter(particles.values())).device
        return SVGDState(
            position=particles,
            historical_grad=tree_zeros_like(particles),
            step=torch.zeros((), dtype=torch.int64, device=device),
            schedule_state=self.stepsize_schedule.init(),
        )

    def _phi(self, flat_particles, flat_grads, key):
        """The transport direction of the kernel implementation."""
        n = flat_particles.shape[0]
        if self.kernel_impl == "streaming":
            with span("svgd.bandwidth"):
                if n <= self.bandwidth_subsample:
                    sub = flat_particles
                else:
                    idx = torch.randint(0, n, (self.bandwidth_subsample,),
                                        generator=key, device=key.device)
                    sub = flat_particles[idx.to(flat_particles.device)]
                h = median_bandwidth(squared_distance_matrix(sub), n)
            with span("svgd.transport"):
                return svgd_phi_streaming(
                    flat_particles, flat_grads, h,
                    tile=min(self.streaming_tile, n),
                    interpret=self.streaming_interpret)
        with span("svgd.transport"):
            kernel, grad_kernel = svgd_kernel(flat_particles)
            # grad_logp = -grad_cost; repulsion per Liu & Wang (2016)
            return (torch.matmul(kernel, -flat_grads) + grad_kernel) / n

    @spanned("svgd.step")
    def step(self, state, key, batch=None, phase=None):
        """One SVGD transport step.  ``key`` is the ``torch.Generator`` of
        the bandwidth subsample (drawn only with more particles than
        ``bandwidth_subsample``); ``batch`` is shared by every particle;
        ``phase`` is accepted for driver uniformity and ignored."""
        del phase
        with span("svgd.gradient"):
            eps = self._stepsize(state)
            grad_and_value = torch.func.grad_and_value(self.cost_fn)
            if batch is None:
                grads, costs = torch.func.vmap(grad_and_value)(state.position)
            else:
                grads, costs = torch.func.vmap(
                    grad_and_value, in_dims=(0, None))(state.position, batch)
            flat_particles, unravel = _ravel_particles(state.position)
            flat_grads, _ = _ravel_particles(grads)

        phi = self._phi(flat_particles, flat_grads, key)

        with span("svgd.update"):
            flat_hist, _ = _ravel_particles(state.historical_grad)
            hist_new = self.alpha * flat_hist + (1.0 - self.alpha) * phi**2
            adjusted = phi / (self.fudge_factor + torch.sqrt(hist_new))
            new_flat = flat_particles + eps * adjusted
            new_state = SVGDState(
                position=unravel(new_flat),
                historical_grad=unravel(hist_new),
                step=state.step + 1,
                schedule_state=self.stepsize_schedule.update(
                    state.schedule_state, cost=costs),
            )
        return new_state, SamplerInfo(cost=costs, stepsize=eps)


__all__ = ["SVGDSampler", "SVGDState"]
