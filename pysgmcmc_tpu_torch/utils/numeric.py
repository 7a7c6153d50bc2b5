"""Numerically-safe elementwise helpers (PyTorch port of
:mod:`pysgmcmc_tpu.utils.numeric`).

Examples
--------
>>> import torch
>>> bool(torch.isfinite(safe_divide(torch.tensor(1.0), torch.tensor(0.0))))
True
>>> float(safe_sqrt(torch.tensor(-1e-16)))
0.0
"""

import torch


def safe_divide(x, y, small_constant=1e-16):
    """Divide ``x / y``, nudging ``y`` away from zero in a sign-aware way:
    ``x / (y + 2 * sign(y) * c + c)`` (the reference's guard)."""
    y = torch.as_tensor(y)
    return x / (y + 2.0 * torch.sign(y) * small_constant + small_constant)


def safe_sqrt(x, clip_value_min=0.0, clip_value_max=float("inf")):
    """``sqrt(clip(x, min, max))`` — no NaNs from tiny negative inputs."""
    return torch.sqrt(torch.clamp(torch.as_tensor(x), clip_value_min,
                                  clip_value_max))


def median(x):
    """Median over all elements of ``x``, as ``numpy.median``: the mean of
    the two central values for an even count.  One sort, as the JAX package
    does (``torch.median`` returns the lower central value, and
    ``torch.quantile`` refuses inputs of more than 2**24 elements).

    Examples
    --------
    >>> float(median(torch.tensor([3.0, 1.0, 2.0])))
    2.0
    >>> float(median(torch.tensor([4.0, 1.0, 2.0, 3.0])))
    2.5
    """
    sorted_vals = torch.sort(torch.ravel(x)).values
    n = sorted_vals.shape[0]
    mid = n // 2
    if n % 2 == 1:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])
