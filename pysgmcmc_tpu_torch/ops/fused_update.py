"""FusedSGHMC's whole step over stacked flat state on Hopper (PyTorch port of
:mod:`pysgmcmc_tpu.ops.fused_update`).

B10 :func:`fused_sghmc_update` advances every chain one SGHMC step: the
scale-adapted EMAs (tau, g, v_hat), all reading their old values, every
step; ``minv = 1/sqrt(old v_hat)`` (guarded) while ``burning_in``, else the
``minv`` it is given; then the noise, the momentum and the position::

    r         = 1 / (tau + 1)
    minv_used = burning_in ? 1 / (sqrt(v_hat) + 2 sign 1e-16 + 1e-16) : minv
    tau'      = tau + (-g^2 tau) / (v_hat + 2 sign 1e-16 + 1e-16) + 1
    g'        = g - r g + r grad
    v_hat'    = v_hat - r v_hat + r grad^2
    sigma     = sqrt(max(2 eps_s^2 mdecay minv_used - eps_s^4, 1e-16))
    v'        = v - eps^2 minv_used grad - mdecay v + sigma eta
    theta'    = theta + v'

with ``eps_s = eps / sqrt(scale_grad)``; there is no prior fold.  The
wrapper launches the kernel of ``csrc/slim_update.cu`` (one more rule of
the slim kernels' body) on CUDA tensors and runs the plain version
:func:`fused_sghmc_update_ref` on CPU tensors; any other device raises, and
nothing falls back from the kernel to its plain version.

Layout: every operand is ``(n_chains, dim)`` float32 with ``dim`` a
multiple of :data:`LANES` (:func:`pad_dim`), the padding that JAX's
``FusedSGHMCState`` has, so the two states have the same shapes.  The noise
is the Philox stream of the port's kernels at (chain, absolute ``step``,
column) with the 64-bit ``seed``, or the injected ``noise``.  Outputs are
new tensors; the inputs are not modified.

Examples
--------
>>> pad_dim(5)
128
>>> pad_dim(200)
256
>>> import torch
>>> ones = torch.ones(2, 128)
>>> out = fused_sghmc_update(torch.zeros(2, 128), torch.zeros(2, 128), ones,
...                          ones, ones, ones, ones, 0.1, True, 0,
...                          noise=torch.zeros(2, 128))
>>> round(float(out[1][0, 0]), 6)  # -eps^2 * minv * grad, minv = 1
-0.01
"""

import torch

from pysgmcmc_tpu_torch.ops.fused_step import (
    _adapt,
    _require_device,
    _sghmc_velocity,
)
from pysgmcmc_tpu_torch.ops.slim_update import (
    _eta,
    _launch,
    _sghmc_row,
    _sqrt_sg,
    _validate,
)

LANES = 128


def pad_dim(dim):
    """Round ``dim`` up to a multiple of the 128-column tile width."""
    return ((dim + LANES - 1) // LANES) * LANES


def _check(name, theta, v, tau, g, v_hat, minv, grad, eps, seed, noise):
    """JAX's width check, then every operand float32 ``(n_chains, dim)`` on
    theta's device and a scalar ``eps``; returns eps as a float32 ``(1,)``
    vector."""
    if theta.ndim == 2 and theta.shape[1] % LANES != 0:
        raise ValueError(
            "{}: dim must be a multiple of {} (use pad_dim); got {}".format(
                name, LANES, theta.shape[1]))
    for t in (v, minv, grad):
        if t.dtype != torch.float32:
            raise ValueError("{}: every operand must be float32; got "
                             "{}".format(name, t.dtype))
    eps_vec = _validate(name, theta, [v, minv], grad, None, eps, seed, noise,
                        f32_state=[tau, g, v_hat])
    if eps_vec.numel() != 1:
        raise ValueError("{}: eps must be a scalar; got {} entries".format(
            name, eps_vec.numel()))
    return eps_vec


def fused_sghmc_update_ref(theta, v, tau, g, v_hat, minv, grad, eps,
                           burning_in, seed, mdecay=0.05, scale_grad=1.0,
                           noise=None, step=0):
    """Plain PyTorch version of :func:`fused_sghmc_update` (JAX's
    ``_update_math`` term by term)."""
    eps_vec = _check("fused_sghmc_update", theta, v, tau, g, v_hat, minv,
                     grad, eps, seed, noise)
    minv_new, tau_new, g_new, v_hat_new = _adapt(tau, g, v_hat, grad)
    minv_used = torch.where(
        torch.as_tensor(burning_in, dtype=torch.bool, device=theta.device),
        minv_new, minv)
    v_new = _sghmc_velocity(v, minv_used, grad,
                            _eta(theta, seed, step, noise),
                            _sghmc_row(eps_vec, scale_grad, theta.device),
                            mdecay)
    return theta + v_new, v_new, tau_new, g_new, v_hat_new, minv_used


def fused_sghmc_update(theta, v, tau, g, v_hat, minv, grad, eps, burning_in,
                       seed, mdecay=0.05, scale_grad=1.0, noise=None, step=0):
    """One FusedSGHMC step over stacked flat state (B10).

    ``theta``, ``v``, ``tau``, ``g``, ``v_hat``, ``minv`` and ``grad`` are
    float32 ``(n_chains, dim)`` with ``dim`` a multiple of 128 (else JAX's
    ``ValueError``); ``eps`` a scalar; ``burning_in`` a bool (or 0-d
    tensor, read on the host) choosing the fresh or the given minv;
    ``seed`` the 64-bit Philox key and ``step`` the absolute step of the
    noise counter, or ``noise`` ``(n_chains, dim)`` injected normals.
    Returns ``(theta', v', tau', g', v_hat', minv_used)``.  CUDA tensors
    launch the kernel; CPU tensors run :func:`fused_sghmc_update_ref`.
    """
    name = "fused_sghmc_update"
    if not _require_device(name, theta):
        return fused_sghmc_update_ref(theta, v, tau, g, v_hat, minv, grad,
                                      eps, burning_in, seed, mdecay,
                                      scale_grad, noise, step)
    eps_vec = _check(name, theta, v, tau, g, v_hat, minv, grad, eps, seed,
                     noise)
    out = _launch(name, dict(theta=theta, v=v, minv=minv, tau=tau, g=g,
                             v_hat=v_hat, grad=grad),
                  ("theta", "v", "tau", "g", "v_hat", "minv"), eps_vec, noise,
                  seed, step, 0.0, burning_in=bool(burning_in),
                  sqrt_sg=_sqrt_sg(scale_grad), coef=mdecay)
    fused_sghmc_update.launches += 1
    return out


fused_sghmc_update.launches = 0


__all__ = ["LANES", "fused_sghmc_update", "fused_sghmc_update_ref",
           "pad_dim"]
