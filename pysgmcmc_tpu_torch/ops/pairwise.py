"""Pairwise distances and the SVGD RBF kernel (PyTorch port of
:mod:`pysgmcmc_tpu.ops.pairwise`).

The distance matrix is one Gram product plus rank-1 broadcasts::

    D_ij = |x_i|^2 + |x_j|^2 - 2 <x_i, x_j>

clamped at zero, as the JAX package computes it (so that rounding matches),
and the median-heuristic bandwidth is one sort.  These are plain XLA in the
JAX package, and plain PyTorch here: the products go to ``torch.matmul``.
``pdist`` / ``squareform`` keep the JAX package's direct differences, for
parity with ``scipy.spatial.distance``.

Examples
--------
>>> import torch
>>> x = torch.tensor([[0.0], [3.0], [4.0]])
>>> [round(float(v), 1) for v in pdist(x)]  # pairs (0,1), (0,2), (1,2)
[3.0, 4.0, 1.0]
>>> tuple(squareform(pdist(x)).shape)
(3, 3)
>>> float(squareform(pdist(x))[0, 2])
4.0
"""

import math

import torch

from pysgmcmc_tpu_torch.utils.numeric import median


def squared_distance_matrix(x):
    """All-pairs squared euclidean distances of the rows of ``x``: one
    matrix product, clamped at zero (the Gram expansion can go slightly
    negative for near-identical rows)."""
    sq_norms = torch.sum(x * x, dim=-1)
    gram = torch.matmul(x, x.T)
    d2 = sq_norms[:, None] + sq_norms[None, :] - 2.0 * gram
    return torch.clamp(d2, min=0.0)


def pdist(x):
    """Condensed pairwise euclidean distances (upper triangle, row-major,
    ``scipy.spatial.distance.pdist``'s order), from direct differences."""
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    rows, cols = torch.triu_indices(n, n, offset=1, device=x.device)
    return torch.sqrt(d2[rows, cols])


def squareform(condensed, n=None):
    """Condensed distance vector -> symmetric square matrix."""
    if n is None:
        # solve n(n-1)/2 = len(condensed)
        n = int(round((1 + math.isqrt(1 + 8 * condensed.shape[0])) / 2))
    out = torch.zeros((n, n), dtype=condensed.dtype, device=condensed.device)
    rows, cols = torch.triu_indices(n, n, offset=1, device=condensed.device)
    out[rows, cols] = condensed
    return out + out.T


def median_bandwidth(d2, n_particles):
    """Median-heuristic RBF bandwidth, a 0-d tensor on ``d2``'s device:
    ``h = sqrt(0.5 * median(D^2) / log(n + 1))``, in ``d2``'s dtype."""
    n = torch.full((), float(n_particles), dtype=d2.dtype, device=d2.device)
    return torch.sqrt(0.5 * median(d2) / torch.log(n + 1.0))


def svgd_kernel(particles):
    """RBF kernel matrix and its summed gradients for SVGD: for ``K_ij =
    exp(-D_ij / (2 h^2))`` with the median bandwidth, returns ``(K, dK)``
    with ``dK_i = (x_i sum_j K_ij - sum_j K_ij x_j) / h^2``."""
    n = particles.shape[0]
    d2 = squared_distance_matrix(particles)
    h = median_bandwidth(d2, n)
    kernel = torch.exp(-d2 / (2.0 * h**2))
    kernel_sum = torch.sum(kernel, dim=1)
    grad_kernel = (particles * kernel_sum[:, None]
                   - torch.matmul(kernel, particles)) / h**2
    return kernel, grad_kernel


__all__ = [
    "median_bandwidth",
    "pdist",
    "squared_distance_matrix",
    "squareform",
    "svgd_kernel",
]
