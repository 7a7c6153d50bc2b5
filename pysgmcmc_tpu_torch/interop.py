"""Weights and sampler state carried between the JAX package and the port.

Everything crosses as numpy arrays, so this module imports no JAX: pass
``np.asarray``-able leaves (JAX arrays qualify) and get tensors back, or the
reverse.  Parameter dicts keep the JAX key names and shapes, with the
leading chain axis where JAX stacks chains.  A bfloat16 leaf (a JAX bf16
array, whose numpy type numpy itself does not define) crosses bit for bit
as a ``torch.bfloat16`` tensor: its 16-bit words are read as ``int16``, so
no ``ml_dtypes`` import is needed; a bf16 tensor comes back as float32
numpy, which holds every bf16 value exactly.

Examples
--------
>>> import numpy as np
>>> params = params_from_numpy({"w1": np.ones((2, 3), np.float32)}, "cpu")
>>> params["w1"].shape, params_to_numpy(params)["w1"].dtype
(torch.Size([2, 3]), dtype('float32'))
"""

import numpy as np
import torch

from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.samplers.fused import FusedSGHMCState
from pysgmcmc_tpu_torch.samplers.psgld import PSGLDState
from pysgmcmc_tpu_torch.samplers.relativistic_sghmc import (
    RelativisticSGHMCState,
)
from pysgmcmc_tpu_torch.samplers.sghmc import SGHMCState
from pysgmcmc_tpu_torch.samplers.sgld import SGLDState
from pysgmcmc_tpu_torch.samplers.sgnht import SGNHTState
from pysgmcmc_tpu_torch.samplers.svgd import SVGDState


def tensor_from_numpy(leaf, device):
    """An ``np.asarray``-able array -> a tensor on ``device`` (a copy); a
    bfloat16 array keeps its bits."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = torch.tensor(arr.view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    return torch.tensor(arr, device=device)


def tensor_to_numpy(leaf):
    """A tensor -> a numpy array (a bfloat16 tensor as float32, exactly)."""
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.float()
    return leaf.numpy()


def params_from_numpy(params, device):
    """Dict of arrays (e.g. JAX ``dense_network`` params, single or stacked,
    float32 or bfloat16) -> dict of tensors on ``device`` (copies)."""
    return {name: tensor_from_numpy(leaf, device)
            for name, leaf in params.items()}


def params_to_numpy(params):
    """Dict of tensors -> dict of numpy arrays."""
    return {name: tensor_to_numpy(leaf) for name, leaf in params.items()}


def _stats_from_numpy(stats, device):
    return AdaptiveStats(
        tau=params_from_numpy(stats.tau, device),
        g=params_from_numpy(stats.g, device),
        v_hat=params_from_numpy(stats.v_hat, device),
        minv=params_from_numpy(stats.minv, device),
    )


def _step_from_numpy(step, device):
    return torch.tensor(np.asarray(step), dtype=torch.int64, device=device)


def sghmc_state_from_numpy(state, device, schedule_state=()):
    """A JAX ``SGHMCState`` (or anything with its fields: ``position``,
    ``momentum``, ``stats.tau/g/v_hat/minv``, ``step``) -> the port's
    :class:`SGHMCState` on ``device``."""
    return SGHMCState(
        position=params_from_numpy(state.position, device),
        momentum=params_from_numpy(state.momentum, device),
        stats=_stats_from_numpy(state.stats, device),
        step=_step_from_numpy(state.step, device),
        schedule_state=schedule_state,
    )


def sgld_state_from_numpy(state, device, schedule_state=()):
    """A JAX ``SGLDState`` (``position``, ``stats.tau/g/v_hat/minv``,
    ``step``) -> the port's :class:`SGLDState` on ``device``."""
    return SGLDState(
        position=params_from_numpy(state.position, device),
        stats=_stats_from_numpy(state.stats, device),
        step=_step_from_numpy(state.step, device),
        schedule_state=schedule_state,
    )


def psgld_state_from_numpy(state, device, schedule_state=()):
    """A JAX ``PSGLDState`` (``position``, ``v``, ``step``) -> the port's
    :class:`PSGLDState` on ``device``."""
    return PSGLDState(
        position=params_from_numpy(state.position, device),
        v=params_from_numpy(state.v, device),
        step=_step_from_numpy(state.step, device),
        schedule_state=schedule_state,
    )


def sgnht_state_from_numpy(state, device, schedule_state=()):
    """A JAX ``SGNHTState`` (``position``, ``momentum``, ``xi``, ``step``)
    -> the port's :class:`SGNHTState` on ``device``; ``xi`` keeps its shape
    (a scalar, or ``(n_chains,)`` from a vmapped ``init``)."""
    return SGNHTState(
        position=params_from_numpy(state.position, device),
        momentum=params_from_numpy(state.momentum, device),
        xi=torch.tensor(np.asarray(state.xi), dtype=torch.float32,
                        device=device),
        step=_step_from_numpy(state.step, device),
        schedule_state=schedule_state,
    )


def rsghmc_state_from_numpy(state, device, schedule_state=()):
    """A JAX ``RelativisticSGHMCState`` (``position``, ``momentum``,
    ``step``) -> the port's :class:`RelativisticSGHMCState` on ``device``
    (JAX's threefry draws of the initial momenta cross here: the port
    cannot redraw them)."""
    return RelativisticSGHMCState(
        position=params_from_numpy(state.position, device),
        momentum=params_from_numpy(state.momentum, device),
        step=_step_from_numpy(state.step, device),
        schedule_state=schedule_state,
    )


def svgd_state_from_numpy(state, device, schedule_state=()):
    """A JAX ``SVGDState`` (``position``, ``historical_grad``, ``step``; the
    particle ensemble as a dict of leaves with a leading particle axis) ->
    the port's :class:`SVGDState` on ``device``."""
    return SVGDState(
        position=params_from_numpy(state.position, device),
        historical_grad=params_from_numpy(state.historical_grad, device),
        step=_step_from_numpy(state.step, device),
        schedule_state=schedule_state,
    )


def fused_sghmc_state_from_numpy(state, device):
    """A JAX ``FusedSGHMCState`` (``theta``, ``momentum``, ``tau``, ``g``,
    ``v_hat``, ``minv``: ``(n_chains, dim_padded)`` arrays; ``step``) -> the
    port's :class:`FusedSGHMCState` on ``device``, its step a host int."""
    return FusedSGHMCState(
        *(tensor_from_numpy(getattr(state, field), device)
          for field in FusedSGHMCState._fields[:-1]),
        step=int(np.asarray(state.step)))


def state_to_numpy(state):
    """Any of the port's sampler states -> a dict of its fields as numpy:
    ``"position"`` and, where the state has them, ``"momentum"``, ``"v"``
    (pSGLD's accumulator) and ``"tau"``, ``"g"``, ``"v_hat"``, ``"minv"``
    (SGHMC's and SGLD's stats) and ``"historical_grad"`` (SVGD's Adagrad
    accumulator) as dicts of arrays, ``"xi"`` (SGNHT) and ``"step"`` as
    arrays; a :class:`FusedSGHMCState` as its fields, each an array."""
    if isinstance(state, FusedSGHMCState):
        out = {field: tensor_to_numpy(getattr(state, field))
               for field in FusedSGHMCState._fields[:-1]}
        out["step"] = np.asarray(state.step)
        return out
    out = {"position": params_to_numpy(state.position),
           "step": np.asarray(state.step.cpu())}
    for field in ("momentum", "v", "historical_grad"):
        if hasattr(state, field):
            out[field] = params_to_numpy(getattr(state, field))
    if hasattr(state, "stats"):
        for field in AdaptiveStats._fields:
            out[field] = params_to_numpy(getattr(state.stats, field))
    if hasattr(state, "xi"):
        out["xi"] = state.xi.detach().cpu().numpy()
    return out
