"""Abstract model interface and normalization helpers (copy of
:mod:`pysgmcmc_tpu.models.base_model`).

The JAX module is numpy-only, but importing it runs
``pysgmcmc_tpu/__init__.py``, which imports jax; the port keeps its own copy.

Examples
--------
>>> import numpy as np
>>> xn, mean, std = zero_mean_unit_var_normalization(np.array([[0.0], [2.0]]))
>>> (float(mean[0]), float(std[0]))
(1.0, 1.0)
>>> bool(np.allclose(
...     zero_mean_unit_var_unnormalization(xn, mean, std), [[0.0], [2.0]]))
True
>>> xu, lo, hi = zero_one_normalization(np.array([2.0, 4.0]))
>>> xu.tolist()
[0.0, 1.0]
"""

import abc

import numpy as np


class BaseModel(abc.ABC):
    """Abstract base class for all models."""

    def __init__(self):
        self.X = None
        self.y = None

    @abc.abstractmethod
    def train(self, X, y):
        """Train on inputs ``X`` of shape (N, D) with targets ``y`` of shape (N,)."""

    @abc.abstractmethod
    def predict(self, X_test):
        """Return predictive ``(mean, variance)`` at ``X_test`` (N, D)."""

    def update(self, X, y):
        """Append new data and retrain."""
        X = np.append(self.X, X, axis=0)
        y = np.append(self.y, y, axis=0)
        self.train(X, y)

    @staticmethod
    def _check_shapes_train(func):
        def wrapper(self, X, y, *args, **kwargs):
            assert X.shape[0] == y.shape[0]
            assert len(X.shape) == 2
            assert len(y.shape) == 1
            return func(self, X, y, *args, **kwargs)

        return wrapper

    @staticmethod
    def _check_shapes_predict(func):
        def wrapper(self, X, *args, **kwargs):
            assert len(X.shape) == 2
            return func(self, X, *args, **kwargs)

        return wrapper

    def get_json_data(self):
        """Serializable snapshot of the model's data."""
        return {
            "X": self.X if self.X is None else np.asarray(self.X).tolist(),
            "y": self.y if self.y is None else np.asarray(self.y).tolist(),
            "hyperparameters": "",
        }

    def get_incumbent(self):
        """Best observed (input, target) pair."""
        best_idx = np.argmin(self.y)
        return self.X[best_idx], self.y[best_idx]


def zero_one_normalization(X, lower=None, upper=None):
    if lower is None:
        lower = np.min(X, axis=0)
    if upper is None:
        upper = np.max(X, axis=0)
    return np.true_divide(X - lower, upper - lower), lower, upper


def zero_one_unnormalization(X_normalized, lower, upper):
    return lower + (upper - lower) * X_normalized


def zero_mean_unit_var_normalization(X, mean=None, std=None):
    if mean is None:
        mean = np.mean(X, axis=0)
    if std is None:
        std = np.std(X, axis=0)
    return (X - mean) / std, mean, std


def zero_mean_unit_var_unnormalization(X_normalized, mean, std):
    return X_normalized * std + mean
