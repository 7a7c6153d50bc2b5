"""Scale-adapted burn-in statistics (PyTorch port of
:mod:`pysgmcmc_tpu.samplers._adaptive`).

Springenberg et al. (NIPS 2016) self-tuning burn-in, with the reference's
read-old-value-then-update order::

    r         = 1 / (tau + 1)                    # OLD tau
    minv_new  = 1 / sqrt(v_hat)                  # OLD v_hat
    tau_new   = tau + (-g*g*tau / v_hat) + 1     # OLD g, v_hat
    g_new     = g - r*g + r*grad
    v_hat_new = v_hat - r*v_hat + r*grad**2

Examples
--------
One update with old tau = g = v_hat = 1 and grad = 2 (so r = 1/2):

>>> import torch
>>> stats = init_stats({"x": torch.ones(1)})
>>> stats, minv = update_stats(stats, {"x": torch.full((1,), 2.0)}, True)
>>> [round(float(leaf["x"][0]), 3) for leaf in (stats.tau, stats.g, stats.v_hat)]
[1.0, 1.5, 2.5]
>>> round(float(minv["x"][0]), 3)
1.0
"""

from typing import Any, NamedTuple

import torch

from pysgmcmc_tpu_torch.utils.numeric import safe_divide, safe_sqrt
from pysgmcmc_tpu_torch.utils.pytree import tree_map


class AdaptiveStats(NamedTuple):
    """Per-leaf burn-in statistics (same shapes as the target parameters)."""

    tau: Any
    g: Any
    v_hat: Any
    minv: Any


def init_stats(params):
    """tau = g = v_hat = 1, minv = 1/sqrt(v_hat) = 1."""
    ones = tree_map(torch.ones_like, params)
    return AdaptiveStats(tau=ones, g=dict(ones), v_hat=dict(ones),
                         minv=dict(ones))


def update_stats(stats, grads, burning_in, phase=None):
    """One burn-in EMA update; returns ``(new_stats, minv_used)``.

    ``minv_used`` is ``1/sqrt(old v_hat)`` while burning in and the frozen
    ``stats.minv`` afterwards.  ``phase`` fixes the side of the burn-in
    boundary: ``None`` selects on ``burning_in`` (a bool or a bool tensor),
    ``"burn_in"`` always adapts, ``"sampling"`` returns the stats untouched.
    """
    if phase == "sampling":
        return stats, stats.minv
    if phase not in (None, "burn_in"):
        raise ValueError(
            "update_stats: phase must be None, 'burn_in' or 'sampling'; "
            "got {!r}".format(phase)
        )

    def fresh_minv(v_hat):
        return safe_divide(1.0, safe_sqrt(v_hat))

    def select(v_hat, frozen):
        # a per-chain (n,) flag broadcasts over each chain's leaf
        cond = torch.as_tensor(burning_in, device=v_hat.device)
        cond = cond.reshape(cond.shape + (1,) * (v_hat.ndim - cond.ndim))
        return torch.where(cond, fresh_minv(v_hat), frozen)

    if phase == "burn_in":
        minv_used = tree_map(fresh_minv, stats.v_hat)
    else:
        minv_used = tree_map(select, stats.v_hat, stats.minv)
    tau_new = tree_map(
        lambda tau, g, v_hat: tau + safe_divide(-g * g * tau, v_hat) + 1.0,
        stats.tau, stats.g, stats.v_hat)

    def g_new(tau, g, grad):
        r = 1.0 / (tau + 1.0)
        return g - r * g + r * grad

    def v_hat_new(tau, v_hat, grad):
        r = 1.0 / (tau + 1.0)
        return v_hat - r * v_hat + r * grad * grad

    new_stats = AdaptiveStats(
        tau=tau_new,
        g=tree_map(g_new, stats.tau, stats.g, grads),
        v_hat=tree_map(v_hat_new, stats.tau, stats.v_hat, grads),
        minv=minv_used,
    )
    return new_stats, minv_used
