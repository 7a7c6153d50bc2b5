"""Sampling the relativistic-momentum marginal (PyTorch port of
:mod:`pysgmcmc_tpu.ops.relativistic`).

The relativistic momentum of Relativistic SGHMC (Lu et al., AISTATS 2017)
has the marginal density

    p(p) ∝ exp(-m c^2 sqrt(p^2 / (m^2 c^2) + 1)) = exp(-c sqrt(p^2 + m^2 c^2))

By Cauchy-Schwarz, for any tilt ``beta in [0, 1)``,
``sqrt(p^2 + (mc)^2) >= beta mc + sqrt(1 - beta^2) |p|``, so a Laplace
proposal of rate ``r = c sqrt(1 - beta^2)`` dominates the target with
acceptance ``exp(-c sqrt(p^2 + (mc)^2) + c beta mc + r |p|)``.  The tilt
that maximises the acceptance is the root of ``beta / (1 - beta^2) = m
c^2`` (about 0.7 per round at m = c = 1).  Each round redraws only the slots
not yet accepted.  Plain PyTorch: no kernel, here or in the JAX package.

Examples
--------
>>> import torch
>>> p = sample_relativistic_momentum(torch.Generator().manual_seed(0), (500,))
>>> p.shape
torch.Size([500])
>>> bool(abs(float(p.mean())) < 0.2)  # symmetric marginal
True
"""

import math

import torch

from pysgmcmc_tpu_torch.utils.pytree import tree_map


def _optimal_tilt(lam):
    """Root of ``beta / (1 - beta^2) = lam`` in [0, 1): the acceptance-rate
    maximising tilt for the target curvature ``lam = m c^2``."""
    return (-1.0 + torch.sqrt(1.0 + 4.0 * lam**2)) / (2.0 * lam)


def sample_relativistic_momentum(generator, shape, m=1.0, c=1.0,
                                 dtype=torch.float32, device=None):
    """``shape`` i.i.d. draws of the relativistic momentum marginal.

    Exact rejection sampling from the optimally tilted Laplace envelope,
    deterministic in the state of ``generator``.  The draws run on the
    generator's device; the result lands on ``device`` (default: the
    generator's).
    """
    gen_device = generator.device
    m = torch.tensor(m, dtype=dtype, device=gen_device)
    c = torch.tensor(c, dtype=dtype, device=gen_device)
    b = m * c  # momentum scale
    beta = _optimal_tilt(m * c**2)
    rate = c * torch.sqrt(1.0 - beta**2)
    n = math.prod(shape)
    samples = torch.empty(n, dtype=dtype, device=gen_device)
    pending = torch.arange(n, device=gen_device)
    while pending.numel():
        k = pending.numel()
        # Laplace(0, 1) by inversion of u in [-1, 1); u = -1 gives -inf,
        # whose acceptance is NaN, so it is redrawn
        u = 2.0 * torch.rand(k, generator=generator, dtype=dtype,
                             device=gen_device) - 1.0
        proposal = -torch.sign(u) * torch.log1p(-torch.abs(u)) / rate
        log_accept = (-c * torch.sqrt(proposal**2 + b**2) + c * beta * b
                      + rate * torch.abs(proposal))
        accept = torch.log(torch.rand(k, generator=generator, dtype=dtype,
                                      device=gen_device)) < log_accept
        samples[pending[accept]] = proposal[accept]
        pending = pending[~accept]
    return samples.reshape(shape).to(gen_device if device is None else device)


def sample_relativistic_momentum_tree(generator, tree, m=1.0, c=1.0):
    """Relativistic-momentum draws shaped like every leaf of ``tree``, in
    the dict's order, each on its leaf's device and in its dtype."""
    return tree_map(
        lambda leaf: sample_relativistic_momentum(
            generator, tuple(leaf.shape), m=m, c=c, dtype=leaf.dtype,
            device=leaf.device),
        tree)


def relativistic_kinetic_energy(p, m=1.0, c=1.0):
    """``K(p) = m c^2 sqrt(p^2 / (m^2 c^2) + 1)``."""
    return m * c**2 * torch.sqrt(p**2 / (m**2 * c**2) + 1.0)


__all__ = [
    "relativistic_kinetic_energy",
    "sample_relativistic_momentum",
    "sample_relativistic_momentum_tree",
]
