"""On-device minibatch selection (PyTorch port of :func:`pysgmcmc_tpu.
data_batches.batch_fn`).

The reference picks a random contiguous window of the dataset each step
(``start ~ U{0, ..., n - batch_size}``).  Here every chain draws its own
window at every step from the Philox stream of the fused kernels
(:func:`~pysgmcmc_tpu_torch.ops.fused_step.philox_windows`): the window
depends only on (seed, chain, absolute step), so the chains-on-lanes
drivers see the windows the fused kernels draw in-kernel from the same
seed.

Examples
--------
>>> import torch
>>> x = torch.arange(10.0).reshape(10, 1)
>>> select = batch_fn(x, torch.arange(10.0), batch_size=4)
>>> xb, yb = select(seed=0, step=0, n_chains=3)
>>> (tuple(xb.shape), tuple(yb.shape))
((3, 4, 1), (3, 4, 1))
>>> bool((xb[:, 1:, 0] - xb[:, :-1, 0] == 1.0).all())  # contiguous windows
True
>>> select(None, 0, 2)[0][:, :, 0].tolist()  # seed None: window 0
[[0.0, 1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0]]

Token sequences stay integer, and ``y`` keeps its trailing shape:

>>> tokens = torch.arange(30).reshape(10, 3)
>>> xb, yb = batch_fn(tokens, tokens + 1, batch_size=4)(None, 0, 2)
>>> (xb.dtype, tuple(xb.shape), tuple(yb.shape))
(torch.int64, (2, 4, 3), (2, 4, 3))
"""

import logging

import torch

from pysgmcmc_tpu_torch.ops.fused_step import (
    data_windows,
    gather_batch,
    philox_windows,
)


def _effective_batch_size(n_examples, batch_size):
    """Shrink the batch to the dataset size, as the reference does."""
    effective = min(batch_size, n_examples)
    if effective != batch_size:
        logging.error(
            "Not enough datapoints to form a minibatch. Batchsize was set to %s",
            effective,
        )
    return effective


def batch_fn(x, y, batch_size=20):
    """Return a minibatch selector ``select(seed, step, n_chains) ->
    (x_batch, y_batch)``.

    ``x_batch`` is ``(n_chains, batch_size, *x.shape[1:])`` (a 1-D ``x``
    counts as one feature) and ``y_batch`` ``(n_chains, batch_size, 1)``,
    both float32 on ``x``'s device: chain ``c`` gets the window that
    :func:`~pysgmcmc_tpu_torch.ops.fused_step.philox_windows` draws for it
    at absolute ``step`` from the 64-bit ``seed``.  ``seed=None`` gives
    every chain window 0 (the degenerate stream, ``noise_impl='zero'``).

    An integer ``x`` (token sequences, one a row) keeps its type, as does
    ``y``, and ``y_batch`` is ``(n_chains, batch_size, *y.shape[1:])``:
    the same windows of rows, gathered by index without materialising
    every window of the data.
    """
    x = torch.as_tensor(x)
    if not (x.is_floating_point() or x.dtype == torch.bool):
        return _token_batches(x, torch.as_tensor(y, device=x.device),
                              batch_size)
    x = x.to(torch.float32)
    if x.ndim == 1:
        x = x[:, None]
    n_examples = x.shape[0]
    batch_size = _effective_batch_size(n_examples, batch_size)
    x_win, y_win = data_windows(x, y, batch_size)
    n_windows = x_win.shape[0]

    def select(seed, step, n_chains):
        widx = _window_index(seed, step, n_chains, n_windows, x.device)
        x_batch, y_batch = gather_batch(x_win, y_win, widx)
        return (x_batch.reshape((n_chains, batch_size) + x.shape[1:]),
                y_batch.reshape(n_chains, batch_size, 1))

    return select


def _window_index(seed, step, n_chains, n_windows, device):
    if seed is None:
        return torch.zeros(n_chains, dtype=torch.int64, device=device)
    return philox_windows(seed, step, n_chains, n_windows, device)


def _token_batches(x, y, batch_size):
    """:func:`batch_fn` of integer rows: chain ``c`` gets rows ``w ..
    w + batch_size - 1`` of ``x`` and ``y``, ``w`` its window."""
    batch_size = _effective_batch_size(x.shape[0], batch_size)
    n_windows = x.shape[0] - batch_size + 1
    offsets = torch.arange(batch_size, device=x.device)

    def select(seed, step, n_chains):
        rows = _window_index(seed, step, n_chains, n_windows,
                             x.device)[:, None] + offsets
        return x[rows], y[rows]

    return select


__all__ = ["batch_fn"]
