"""SGHMC over stacked flat chains on kernel B10 (PyTorch port of
:mod:`pysgmcmc_tpu.samplers.fused`).

The sampler state is six ``(n_chains, dim_padded)`` float32 tensors (theta,
momentum, tau, g, v_hat, minv), each chain's parameters raveled in JAX's
``ravel_pytree`` order (the dict's keys sorted, each leaf row-major) and
padded to a multiple of 128 columns, as JAX's ``FusedSGHMCState``.  Each
step takes every chain's gradient with ``torch.func.vmap`` of autograd and
makes one launch of :func:`~pysgmcmc_tpu_torch.ops.fused_update.
fused_sghmc_update` (B10), which adapts the burn-in EMAs, draws the noise
and moves the momentum and the position.  The padding columns get a zero
gradient and drift as JAX's do; they are never read.

The step count is kept on the host (a Python int, where JAX's is an int32
array), so the burn-in switch costs no wait for the card.  ``backend=
"xla"`` runs the same math as plain PyTorch with a normal drawn from the
caller's ``torch.Generator`` (JAX's ``key``); ``backend="pallas"`` launches
B10 with the Philox stream keyed by ``seed`` at (chain, absolute step,
column).  ``noise_impl="zero"`` is the test mode that reproduces JAX's
interpret-mode stream, whose zero random bits give zero noise (and window
0 of a ``batch_fn``): the tests compare the two packages on it.
``interpret=True`` runs the plain version, on CPU tensors only (it does not
zero the noise: that is ``noise_impl``'s job).

Examples
--------
>>> import torch
>>> fused = FusedSGHMC(lambda p: torch.sum(p["x"] ** 2),
...                    {"x": torch.zeros(2)}, interpret=True)
>>> state = fused.init({"x": torch.zeros((4, 2))})
>>> tuple(state.theta.shape)  # 4 chains, dim padded to 128 columns
(4, 128)
>>> back = fused.unflatten_positions(state.theta)
>>> tuple(back["x"].shape)
(4, 2)
"""

import math
from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.ops.fused_update import (
    fused_sghmc_update,
    fused_sghmc_update_ref,
    pad_dim,
)


class FusedSGHMCState(NamedTuple):
    theta: Any  # (n_chains, dim_padded)
    momentum: Any
    tau: Any
    g: Any
    v_hat: Any
    minv: Any
    step: Any  # the step count, a Python int on the host


class FusedSGHMC:
    """Stacked-chain SGHMC driven by the fused update kernel B10.

    Parameters mirror :class:`~pysgmcmc_tpu_torch.samplers.sghmc.
    SGHMCSampler`; ``template_params`` (a dict of tensors) fixes the
    parameter structure that ``cost_fn`` expects for one chain.
    ``compute_dtype`` runs the network on leaves cast to it (the gradient
    lands float32 through the cast, as in JAX); ``noise_impl`` is
    ``"auto"`` or ``"box_muller"`` (the Philox stream) or ``"zero"`` (the
    test mode above), as the port's lanes drivers take it; JAX's has no
    other generator, so ``"hadamard_clt"`` raises ``ValueError``.
    """

    def __init__(self, cost_fn, template_params, stepsize=0.01,
                 burn_in_steps=3000, mdecay=0.05, scale_grad=1.0, seed=0,
                 interpret=False, backend="pallas", compute_dtype=None,
                 noise_impl="auto"):
        self.names = tuple(sorted(template_params))
        self.shapes = tuple(tuple(template_params[k].shape)
                            for k in self.names)
        self.sizes = tuple(math.prod(shape) for shape in self.shapes)
        self.dim = sum(self.sizes)
        self.dim_padded = pad_dim(self.dim)
        self.cost_fn = cost_fn
        self.stepsize = float(stepsize)
        self.burn_in_steps = int(burn_in_steps)
        self.mdecay = float(mdecay)
        self.scale_grad = float(scale_grad)
        self.seed = int(seed) % 2**64
        self.interpret = bool(interpret)
        if backend not in ("pallas", "xla"):
            raise ValueError("FusedSGHMC: backend must be 'pallas' or 'xla'")
        self.backend = backend
        self.compute_dtype = compute_dtype
        from pysgmcmc_tpu_torch.parallel.packed import box_muller_noise

        self.noise_impl = box_muller_noise("FusedSGHMC", noise_impl)

    #  State --------------------------------------------------------------------

    def flatten_positions(self, stacked_params):
        """``(n_chains, ...)`` dict -> ``(n_chains, dim_padded)`` float32."""
        first = stacked_params[self.names[0]]
        n = first.shape[0]
        theta = torch.cat([stacked_params[k].reshape(n, size).float()
                           for k, size in zip(self.names, self.sizes)], dim=1)
        return torch.nn.functional.pad(theta,
                                       (0, self.dim_padded - self.dim))

    def unflatten_positions(self, theta):
        """``(n_chains, dim_padded)`` -> ``(n_chains, ...)`` dict of views
        (any leading axes, or none: one chain's row -> its dict)."""
        lead = tuple(theta.shape[:-1])
        out, off = {}, 0
        for k, size, shape in zip(self.names, self.sizes, self.shapes):
            out[k] = theta[..., off:off + size].reshape(lead + shape)
            off += size
        return out

    def init(self, stacked_params):
        theta = self.flatten_positions(stacked_params)
        ones = torch.ones_like(theta)
        return FusedSGHMCState(theta=theta, momentum=torch.zeros_like(theta),
                               tau=ones, g=ones.clone(), v_hat=ones.clone(),
                               minv=ones.clone(), step=0)

    #  Stepping -----------------------------------------------------------------

    def _grads(self, theta, batch):
        """Every chain's cost ``(n_chains,)`` and gradient ``(n_chains,
        dim_padded)`` (float32; 0 on the padding)."""
        def flat_cost(row, *batch_args):
            params = self.unflatten_positions(row)
            if self.compute_dtype is not None:
                params = {k: leaf.to(self.compute_dtype)
                          for k, leaf in params.items()}
            return self.cost_fn(params, *batch_args)

        grad_and_cost = torch.func.vmap(torch.func.grad_and_value(flat_cost))
        if batch is None:
            grads, costs = grad_and_cost(theta)
        else:
            grads, costs = grad_and_cost(theta, batch)
        return costs, grads

    def step(self, state, batch=None, key=None):
        """Advance all chains one step; returns ``(state, costs)``.
        ``batch`` has a leading chain axis.  ``key`` (a ``torch.Generator``)
        is required for the 'xla' backend's noise; the 'pallas' backend
        draws its own from ``seed`` at the absolute step."""
        if self.interpret and state.theta.device.type != "cpu":
            raise ValueError(
                "FusedSGHMC: interpret=True runs the plain version, on CPU "
                "tensors only; CUDA tensors launch the kernel (pass "
                "interpret=False)")
        costs, grads = self._grads(state.theta, batch)
        burning_in = state.step < self.burn_in_steps
        noise = (torch.zeros_like(state.theta)
                 if self.noise_impl == "zero" else None)
        args = (state.theta, state.momentum, state.tau, state.g, state.v_hat,
                state.minv, grads, self.stepsize, burning_in, self.seed)
        kw = dict(mdecay=self.mdecay, scale_grad=self.scale_grad,
                  step=state.step)
        if self.backend == "xla":
            if key is None:
                raise ValueError("FusedSGHMC.step: backend='xla' needs a key")
            if noise is None:
                noise = torch.randn(state.theta.shape, generator=key,
                                    device=key.device).to(state.theta.device)
            outs = fused_sghmc_update_ref(*args, noise=noise, **kw)
        else:
            outs = fused_sghmc_update(*args, noise=noise, **kw)
        return FusedSGHMCState(*outs, step=state.step + 1), costs

    def run(self, state, key, n_steps, batch_fn=None, per_chain_batches=True):
        """``n_steps`` steps; returns ``(state, final_costs)``.

        ``key`` is a ``torch.Generator``: the windows' seed is drawn from it
        once (``None`` under ``noise_impl="zero"``: window 0), and the 'xla'
        backend draws its noise from it.  ``batch_fn`` is a selector of
        :func:`pysgmcmc_tpu_torch.data_batches.batch_fn`, ``batch_fn(seed,
        step, n_chains)``; with ``per_chain_batches`` each chain draws its
        own window at each step, else chain 0's is broadcast to every
        chain.
        """
        from pysgmcmc_tpu_torch.parallel.packed import _draw_seed

        n_chains = state.theta.shape[0]
        window_seed = None if self.noise_impl == "zero" else _draw_seed(key)
        costs = None
        for _ in range(int(n_steps)):
            if batch_fn is None:
                batch = None
            elif per_chain_batches:
                batch = batch_fn(window_seed, state.step, n_chains)
            else:
                batch = tuple(
                    leaf[:1].expand((n_chains,) + leaf.shape[1:])
                    for leaf in batch_fn(window_seed, state.step, 1))
            state, costs = self.step(state, batch, key=key)
        return state, costs


__all__ = ["FusedSGHMC", "FusedSGHMCState"]
