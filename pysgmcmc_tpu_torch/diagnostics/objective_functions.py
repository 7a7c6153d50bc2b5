"""Objective functions (PyTorch port of the part of
:mod:`pysgmcmc_tpu.diagnostics.objective_functions` the BNN data needs).

Examples
--------
>>> import torch
>>> sinc(torch.tensor([[0.5]])).tolist()
[1.0]
"""

import torch


def sinc(x):
    """``sinc(10x - 5)`` summed over features — the BNN regression target."""
    return torch.sum(torch.sinc(torch.as_tensor(x) * 10 - 5), dim=1)
