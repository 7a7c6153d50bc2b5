"""Helpers over parameter dicts of tensors (PyTorch port of the parts of
:mod:`pysgmcmc_tpu.utils.pytree` the BNN paths and the samplers use).

A "tree" here is a flat ``dict`` mapping names to tensors, the port's
counterpart of the JAX package's dict pytrees.

Examples
--------
>>> import torch
>>> tree = {"b": torch.zeros(3), "w": torch.zeros(2, 3)}
>>> tree_size(tree)
9
>>> tree_cast(tree, torch.float64)["w"].dtype
torch.float64
"""

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over dicts that share their keys."""
    return {name: fn(*(tree[name] for tree in trees)) for name in trees[0]}


def tree_size(tree):
    """Total number of scalar elements across all leaves."""
    return sum(leaf.numel() for leaf in tree.values())


def tree_zeros_like(tree, dtype=None):
    return tree_map(
        lambda leaf: torch.zeros_like(leaf, dtype=dtype or leaf.dtype), tree)


def tree_cast(tree, dtype):
    return tree_map(lambda leaf: leaf.to(dtype), tree)


def normal_like_tree(generator, tree):
    """A standard-normal draw shaped like every leaf of ``tree``, in the
    dict's order, from ``generator``.  The draw runs on the generator's
    device and lands on each leaf's, so a CPU generator gives the same
    numbers to leaves on the CPU and on the card.  (JAX folds one key per
    leaf; the streams differ, the distribution does not.)"""
    return tree_map(
        lambda leaf: torch.randn(leaf.shape, generator=generator,
                                 dtype=leaf.dtype,
                                 device=generator.device).to(leaf.device),
        tree)
