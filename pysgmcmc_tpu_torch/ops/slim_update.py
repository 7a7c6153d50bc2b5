"""Slim elementwise sampler updates on Hopper: one pass over the packed
state per step of the chains-on-lanes, packed and stacked drivers.

PyTorch port of the packed-state kernels of
:mod:`pysgmcmc_tpu.ops.slim_update`.  Each wrapper launches a hand-written
CUDA kernel of ``csrc/slim_update.cu`` on CUDA tensors and runs its plain
PyTorch version (``*_ref``) on CPU tensors; any other device raises, and
nothing falls back from a kernel to its plain version.

- B7 :func:`slim_sghmc_update`: SGHMC sampling update with a frozen
  ``minv``::

      sigma  = sqrt(max(2 eps_s^2 mdecay minv - eps_s^4, 1e-16))
      v'     = v - eps^2 minv (grad + prior_scale theta) - mdecay v + sigma eta
      theta' = theta + v'

  with ``eps_s = eps / sqrt(scale_grad)``.  B7 mask: with a ``(1, P)``
  ``mask`` row, ``v'`` is multiplied by it (the packed driver's slot
  padding, :func:`pysgmcmc_tpu_torch.parallel.packed.pack_mask`).
- B7' :func:`slim_sghmc_update_tree`: B7 over every leaf of a stacked
  parameter dict in one launch, each leaf in its own shape, optionally
  emitting a bf16 copy of ``theta'`` (``sample_chain_stacked``).
- B8-sgld :func:`slim_sgld_update`: ``theta' = theta - eps minv A g +
  sqrt(2 eps minv A / scale_grad) eta``, ``g = grad + prior_scale theta``.
- B8-psgld :func:`slim_psgld_update`: ``v' = alpha v + (1 - alpha) g^2``,
  ``G = 1 / (lambda + sqrt(max(v', 0)))``, ``theta' = theta - eps/2 G g +
  sqrt(max(eps G / scale_grad, 0)) eta``.
- B8-rsghmc :func:`slim_rsghmc_update`: with ``vel(p) = eps p / m /
  sqrt(p^2 / (m^2 c^2) + 1)``, ``p' = p - eps g + sqrt(max(eps (2D - eps
  Bhat), 0)) eta - D vel(p)`` and ``theta' = theta + vel(p')``.
- B8-sgnht :func:`slim_sgnht_update`: ``p' = p - xi eps p - eps g +
  sqrt(max(2 A eps / scale_grad, 0)) eta``, ``theta' = theta + eps p'``,
  with one ``xi`` per chain; the thermostat's own update is a reduction
  over the chain's row and stays in the driver.
- B9-sghmc :func:`slim_sghmc_burnin_update` / B9-sgld
  :func:`slim_sgld_burnin_update`: the Springenberg et al. tau/g/v_hat EMAs,
  all reading old values, with ``minv = 1/sqrt(old v_hat)`` (guarded), then
  the SGHMC or SGLD update with that ``minv``; they also return it.

The gradient comes from the driver (autograd); the kernels add the prior
fold, draw the noise and apply the rule.  The math is shared with the fused
kernels' plain versions (:mod:`pysgmcmc_tpu_torch.ops.fused_step`).

Layout: every operand is ``(n_chains, P)``, one chain per row, the leaves
of the parameter dict in its order (``parallel.packed.pack_lanes``), or
for B7 mask the packed driver's slots (``parallel.packed.pack_tree``), at
most :data:`MAX_ROW` columns (wider rows raise ``ValueError``).  theta,
tau, g and v_hat are float32; ``v`` (momentum or accumulator), ``minv`` and
``grad`` may be float32 or bfloat16, as JAX's slim kernels let them arrive
(a bf16 network pass, ``state_dtype=bfloat16``): the arithmetic is float32,
``v'`` keeps ``v``'s type (rounded to nearest even), the other outputs are
float32.
The TPU's ``(rows, n_chains)`` lanes layout and its padding do not carry
over: only B7 takes a ``mask`` (the packed layout's), the others raise on
one, and SGNHT's ``xi`` is ``(n_chains,)`` where JAX's is a ``(1,
n_chains)`` row.  ``eps`` is a scalar or an ``(n_chains,)``
per-chain vector (the ``TracedStepsizeSchedule`` sweep pattern).  The noise
is the Philox stream of the fused kernels at ``(chain, step, element)`` with
the 64-bit ``seed`` (B7 mask: element ``noise_index[column]`` where that
row is given; B7': the element's index in the chain's unpadded row, the
leaves in the dict's order), or the injected ``noise`` ``(n_chains, P)``.  Outputs
are new tensors; the inputs are not modified.

Examples
--------
>>> import torch
>>> theta, v = torch.zeros(2, 3), torch.zeros(2, 3)
>>> grad, minv = torch.ones(2, 3), torch.ones(2, 3)
>>> theta2, v2 = slim_sghmc_update(theta, v, grad, minv, None, 0.1, 0,
...                                noise=torch.zeros(2, 3))
>>> torch.allclose(v2, torch.full((2, 3), -0.01))  # -eps^2 minv grad
True
"""

import math

import torch

from pysgmcmc_tpu_torch.ops.fused_step import (
    _MASK32,
    STATE_DTYPES,
    _adapt,
    _check_xi,
    _f32,
    _psgld_update,
    _require_device,
    _rsghmc_update,
    _seed_key,
    _sghmc_table,
    _sgld_constants,
    _sgld_delta,
    _sghmc_velocity,
    _sgnht_update,
    philox_normals,
)


#  Validation, shared by the kernels and their plain versions -----------------

# The widest row the kernels index: csrc/slim_update.cu walks a row's
# columns with 32-bit signed counters that step by up to 2**20 (1024 blocks
# of 256 threads, four columns a thread), so a column plus one stride must
# stay below 2**31.
MAX_ROW = 2**31 - 2**20


def _check_row(name, width):
    if width > MAX_ROW:
        raise ValueError(
            "{}: a row of {} parameters is wider than the kernels' 32-bit "
            "column index covers ({} at most)".format(name, width, MAX_ROW))


def _validate(name, theta, state, grad, mask, eps, seed, noise,
              f32_state=(), noise_index=None):
    """Check every operand; returns the stepsize as a float32 ``(1,)`` or
    ``(n_chains,)`` vector, where ``eps`` was (a float stays on the host,
    so a scalar launch reads no device memory).  ``state`` (v, minv) and
    ``grad`` may be float32 or bfloat16, ``f32_state`` (tau, g, v_hat)
    float32.  Only ``slim_sghmc_update`` takes a ``mask`` and a
    ``noise_index``."""
    _seed_key(seed)
    if (mask is not None or noise_index is not None) \
            and name != "slim_sghmc_update":
        raise NotImplementedError(
            "{}: the padding mask of the TPU's packed layout is ported for "
            "slim_sghmc_update only, the packed driver's kernel (ROADMAP.md "
            "queue B); the port's (n_chains, P) lanes layout has no padding, "
            "pass mask=None".format(name))
    if theta.ndim != 2 or theta.dtype != torch.float32:
        raise ValueError(
            "{}: theta must be a float32 (n_chains, P) tensor; got {} "
            "{}".format(name, theta.dtype, tuple(theta.shape)))
    _check_row(name, theta.shape[1])
    device = theta.device
    for arrs, dtypes, what in (((*state, grad), STATE_DTYPES,
                                "float32 or bfloat16"),
                               (f32_state, (torch.float32,), "float32")):
        for arr in arrs:
            if (arr.shape != theta.shape or arr.dtype not in dtypes
                    or arr.device != device):
                raise ValueError(
                    "{}: every state tensor and the gradient must match "
                    "theta ({} {} on {}); got {} {} on {}".format(
                        name, tuple(theta.shape), what, device,
                        tuple(arr.shape), arr.dtype, arr.device))
    if noise is not None and (noise.shape != theta.shape
                              or noise.dtype != torch.float32
                              or noise.device != device):
        raise ValueError("{}: noise must be float32 {} on {}".format(
            name, tuple(theta.shape), device))
    _check_mask(name, theta, mask, noise_index)
    eps_vec = torch.as_tensor(eps, dtype=torch.float32).reshape(-1)
    if eps_vec.numel() not in (1, theta.shape[0]):
        raise ValueError(
            "{}: per-chain eps must have one entry per chain; got {} "
            "entries for {} chains".format(name, eps_vec.numel(),
                                           theta.shape[0]))
    return eps_vec


def _check_mask(name, theta, mask, noise_index):
    """JAX's check of B7's mask (a ``(1, width)`` row), in float32 on
    theta's device; and the port's ``noise_index``, an int32 ``(width,)``
    row that comes with a mask."""
    width = theta.shape[1]
    if mask is not None and tuple(mask.shape) != (1, width):
        raise ValueError("{}: mask must be (1, {}); got {}".format(
            name, width, tuple(mask.shape)))
    if mask is not None and (mask.dtype != torch.float32
                             or mask.device != theta.device):
        raise ValueError("{}: mask must be float32 on {}; got {} on "
                         "{}".format(name, theta.device, mask.dtype,
                                     mask.device))
    if noise_index is not None and (
            mask is None or tuple(noise_index.shape) != (width,)
            or noise_index.dtype != torch.int32
            or noise_index.device != theta.device):
        raise ValueError(
            "{}: noise_index must be an int32 ({},) row on {}, with a "
            "mask".format(name, width, theta.device))


def _eta(theta, seed, step, noise, noise_index=None):
    if noise is not None:
        return noise
    return philox_normals(seed, step, theta.shape[0], theta.shape[1],
                          theta.device, noise_index)


def _sghmc_row(eps_vec, scale_grad, device):
    """``(eps, eps / sqrt(scale_grad))`` as columns, one row per chain (or
    one row for a scalar)."""
    tab = _sghmc_table(eps_vec.to(device), scale_grad)
    return tab[:, 0:1], tab[:, 1:2]


#  Plain versions ---------------------------------------------------------------

def slim_sghmc_update_ref(theta, v, grad, minv, mask, eps, seed, mdecay=0.05,
                          scale_grad=1.0, prior_scale=0.0, noise=None,
                          step=0, noise_index=None):
    """Plain PyTorch version of :func:`slim_sghmc_update`."""
    eps_vec = _validate("slim_sghmc_update", theta, [v, minv], grad, mask,
                        eps, seed, noise, noise_index=noise_index)
    gg = grad.float() + prior_scale * theta
    v_new = _sghmc_velocity(v.float(), minv.float(), gg,
                            _eta(theta, seed, step, noise, noise_index),
                            _sghmc_row(eps_vec, scale_grad, theta.device),
                            mdecay, mask)
    return theta + v_new, v_new.to(v.dtype)


def slim_sgld_update_ref(theta, grad, minv, mask, eps, seed, a_coef=1.0,
                         scale_grad=1.0, prior_scale=0.0, noise=None, step=0):
    """Plain PyTorch version of :func:`slim_sgld_update`."""
    eps_vec = _validate("slim_sgld_update", theta, [minv], grad, mask, eps,
                        seed, noise)
    a_coef, c = _sgld_constants(a_coef, scale_grad, False)
    gg = grad.float() + prior_scale * theta
    return theta + _sgld_delta(minv.float(), gg,
                               _eta(theta, seed, step, noise),
                               eps_vec.to(theta.device)[:, None], a_coef, c,
                               False)


def slim_psgld_update_ref(theta, v, grad, mask, eps, seed, alpha=0.99,
                          lambda_reg=1e-5, scale_grad=1.0, prior_scale=0.0,
                          noise=None, step=0):
    """Plain PyTorch version of :func:`slim_psgld_update`."""
    eps_col = _validate("slim_psgld_update", theta, [v], grad, mask, eps,
                        seed, noise).to(theta.device)[:, None]
    theta, v_new = _psgld_update(
        theta, v.float(), grad.float() + prior_scale * theta,
        _eta(theta, seed, step, noise), eps_col, _f32(alpha), lambda_reg,
        _f32(1.0 / scale_grad))
    return theta, v_new.to(v.dtype)


def slim_rsghmc_update_ref(theta, p, grad, mask, eps, seed, d_coef=1.0,
                           bhat=0.0, mass=1.0, speed_of_light=1.0,
                           prior_scale=0.0, noise=None, step=0):
    """Plain PyTorch version of :func:`slim_rsghmc_update`."""
    eps_col = _validate("slim_rsghmc_update", theta, [p], grad, mask, eps,
                        seed, noise).to(theta.device)[:, None]
    noise_scale = torch.sqrt(torch.clamp(
        eps_col * (2.0 * d_coef - eps_col * bhat), min=0.0))
    theta, p_new = _rsghmc_update(
        theta, p.float(), grad.float() + prior_scale * theta,
        _eta(theta, seed, step, noise), eps_col, noise_scale, d_coef,
        _f32(1.0 / mass), _f32(1.0 / (mass**2 * speed_of_light**2)))
    return theta, p_new.to(p.dtype)


def slim_sgnht_update_ref(theta, p, grad, mask, xi, eps, seed, a_diff=1.0,
                          scale_grad=1.0, prior_scale=0.0, noise=None,
                          step=0):
    """Plain PyTorch version of :func:`slim_sgnht_update`."""
    eps_col = _validate("slim_sgnht_update", theta, [p], grad, mask, eps,
                        seed, noise).to(theta.device)[:, None]
    _check_xi("slim_sgnht_update", theta, xi)
    sigma = torch.sqrt(torch.clamp(2.0 * a_diff * eps_col / scale_grad,
                                   min=0.0))
    theta, p_new = _sgnht_update(
        theta, p.float(), grad.float() + prior_scale * theta,
        _eta(theta, seed, step, noise), xi, eps_col, sigma)
    return theta, p_new.to(p.dtype)


def slim_sghmc_burnin_update_ref(theta, v, tau, g, v_hat, grad, mask, eps,
                                 seed, mdecay=0.05, scale_grad=1.0,
                                 prior_scale=0.0, noise=None, step=0):
    """Plain PyTorch version of :func:`slim_sghmc_burnin_update`."""
    eps_vec = _validate("slim_sghmc_burnin_update", theta, [v], grad, mask,
                        eps, seed, noise, f32_state=[tau, g, v_hat])
    gg = grad.float() + prior_scale * theta
    minv, tau, g, v_hat = _adapt(tau, g, v_hat, gg)
    v_new = _sghmc_velocity(v.float(), minv, gg,
                            _eta(theta, seed, step, noise),
                            _sghmc_row(eps_vec, scale_grad, theta.device),
                            mdecay)
    return theta + v_new, v_new.to(v.dtype), tau, g, v_hat, minv


def slim_sgld_burnin_update_ref(theta, tau, g, v_hat, grad, mask, eps, seed,
                                a_coef=1.0, scale_grad=1.0, prior_scale=0.0,
                                noise=None, step=0):
    """Plain PyTorch version of :func:`slim_sgld_burnin_update`."""
    eps_vec = _validate("slim_sgld_burnin_update", theta, [], grad, mask,
                        eps, seed, noise, f32_state=[tau, g, v_hat])
    a_coef, c = _sgld_constants(a_coef, scale_grad, True)
    gg = grad.float() + prior_scale * theta
    minv, tau, g, v_hat = _adapt(tau, g, v_hat, gg)
    theta = theta + _sgld_delta(minv, gg, _eta(theta, seed, step, noise),
                                eps_vec.to(theta.device)[:, None], a_coef, c,
                                True)
    return theta, tau, g, v_hat, minv


#  Kernel wrappers ----------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


# the operands of every launch entry of csrc/slim_update.cu, in its argument
# order; a kernel passes NULL for those its rule and phase do not have
_IN = ("theta", "v", "minv", "tau", "g", "v_hat", "grad", "xi")
_OUT = ("theta", "v", "tau", "g", "v_hat", "minv")
# and its rule constants (the Args fields of the same names)
_CONSTS = ("sqrt_sg", "coef", "cdiv", "c2", "c3")


def _launch(name, ins, outs, eps_vec, noise, seed, step, prior_scale,
            mask=None, noise_index=None, burning_in=False, **consts):
    """Launch the C entry ``name + "_launch"`` of ``csrc/slim_update.cu``.

    ``ins`` maps operand names (``_IN``) to tensors (``(n_chains, P)``;
    ``xi`` ``(n_chains,)``; ``v``, ``minv`` and ``grad`` float32 or
    bfloat16), ``outs`` names the outputs to allocate (``v'`` in ``v``'s
    type, the others float32).  A
    one-entry ``eps_vec`` goes as the scalar argument, a per-chain one as
    the kernel's eps vector.  ``consts`` are the rule's constants
    (``_CONSTS``, each 0 where not given), as the source's ``Args`` lists
    them per rule; ``mask``/``noise_index`` B7's rows, ``burning_in`` B10's
    phase.  Raises on a failed launch; returns the outputs in ``outs``
    order.
    """
    from pysgmcmc_tpu_torch.ops import _build

    unknown = set(consts) - set(_CONSTS)
    if unknown:
        raise TypeError("{}: unknown rule constants {}".format(
            name, sorted(unknown)))
    theta = ins["theta"]
    for arr in (*ins.values(), noise, mask, noise_index):
        if arr is not None and not arr.is_contiguous():
            raise ValueError("{}: CUDA operands must be contiguous".format(name))
    per_chain = eps_vec.numel() > 1
    eps_dev = eps_vec.to(theta.device).contiguous() if per_chain else None
    lib = _build.load("slim_update")
    n, p = theta.shape
    out = {key: torch.empty_like(ins["v"] if key == "v" else theta)
           for key in outs}
    with torch.cuda.device(theta.device):  # the launch uses the current device
        _build.check(getattr(lib, name + "_launch")(
            *[_ptr(ins.get(key)) for key in _IN], _ptr(eps_dev), _ptr(noise),
            *[_ptr(out.get(key)) for key in _OUT], n, p, int(seed),
            int(step) & _MASK32, 0.0 if per_chain else float(eps_vec[0]),
            *[float(consts.get(key, 0.0)) for key in _CONSTS],
            float(prior_scale),
            *[int(key in ins and ins[key].dtype == torch.bfloat16)
              for key in ("v", "minv", "grad")],
            _ptr(mask), _ptr(noise_index), int(bool(burning_in)),
            torch.cuda.current_stream().cuda_stream), "slim_update")
    return tuple(out[key] for key in outs)


def _sqrt_sg(scale_grad):
    """``sqrt(scale_grad)`` in float32, SGHMC's noise-scale divisor."""
    return float(torch.sqrt(torch.tensor(scale_grad, dtype=torch.float32)))


def slim_sghmc_update(theta, v, grad, minv, mask, eps, seed, mdecay=0.05,
                      scale_grad=1.0, prior_scale=0.0, noise=None, step=0,
                      noise_index=None):
    """One SGHMC sampling step over packed state with a frozen ``minv``
    (B7; B7 mask with a ``mask``).

    ``theta``, ``v``, ``grad``, ``minv`` are ``(n_chains, P)``, ``theta``
    float32 and the others float32 or bfloat16 (``v'`` keeps ``v``'s type);
    ``mask`` ``None`` or a float32 ``(1, P)`` row that multiplies ``v'``
    (1 on real columns, 0 on slot padding; any other shape raises JAX's
    ``ValueError``); ``eps`` a scalar or ``(n_chains,)``; ``seed`` the
    64-bit Philox key and ``step`` the absolute step of the noise counter,
    or ``noise`` ``(n_chains, P)`` injected normals.  ``noise_index`` (with
    a mask only) is an int32 ``(P,)`` row giving each column's element of
    the stream (values in ``[0, 2**32)``; by default the column itself).
    Unlike JAX's, ``P`` need not be a multiple of 128.  Returns ``(theta',
    v')``.  CUDA tensors launch the kernel; CPU tensors run
    :func:`slim_sghmc_update_ref`.
    """
    name = "slim_sghmc_update"
    if not _require_device(name, theta):
        return slim_sghmc_update_ref(theta, v, grad, minv, mask, eps, seed,
                                     mdecay, scale_grad, prior_scale, noise,
                                     step, noise_index)
    eps_vec = _validate(name, theta, [v, minv], grad, mask, eps, seed, noise,
                        noise_index=noise_index)
    out = _launch(name, dict(theta=theta, v=v, minv=minv, grad=grad),
                  ("theta", "v"), eps_vec, noise, seed, step, prior_scale,
                  mask=mask, noise_index=noise_index,
                  sqrt_sg=_sqrt_sg(scale_grad), coef=mdecay)
    slim_sghmc_update.launches += 1
    return out


slim_sghmc_update.launches = 0


#  B7': the stacked tree -------------------------------------------------------

def _check_tree(name, theta, v, grad, minv, eps, seed, noise):
    """Check a stacked tree's operands: dicts with theta's keys, leaves
    ``(n_chains, *shape)``; theta, v, minv and noise float32, grad float32
    or bfloat16 (one type for every leaf), all on one device; a scalar
    ``eps``.  Returns the stepsize as a float32 ``(1,)`` vector."""
    _seed_key(seed)
    trees = dict(v=v, grad=grad, minv=minv)
    if noise is not None:
        trees["noise"] = noise
    if not isinstance(theta, dict) or not theta:
        raise ValueError("{}: theta must be a non-empty dict of stacked "
                         "leaves".format(name))
    for what, tree in trees.items():
        if not isinstance(tree, dict) or set(tree) != set(theta):
            raise ValueError("{}: {} must be a dict with theta's "
                             "keys".format(name, what))
    first = next(iter(theta.values()))
    grad_dtypes = {leaf.dtype for leaf in grad.values()}
    if len(grad_dtypes) != 1 or not grad_dtypes <= set(STATE_DTYPES):
        raise ValueError("{}: grad must be a dict of float32 or bfloat16 "
                         "leaves, all of one type".format(name))
    for key, t in theta.items():
        if t.dtype != torch.float32 or t.ndim < 1 or first.ndim < 1 \
                or t.shape[0] != first.shape[0] or t.device != first.device:
            raise ValueError(
                "{}: theta[{!r}] must be a float32 (n_chains, ...) leaf on "
                "{}; got {} {}".format(name, key, first.device, t.dtype,
                                       tuple(t.shape)))
        for what, tree in trees.items():
            leaf = tree[key]
            want = grad_dtypes if what == "grad" else {torch.float32}
            if leaf.shape != t.shape or leaf.dtype not in want \
                    or leaf.device != t.device:
                raise ValueError(
                    "{}: {}[{!r}] must match theta ({} {} on {}); got {} {} "
                    "on {}".format(name, what, key, tuple(t.shape),
                                   "/".join(str(d) for d in want), t.device,
                                   tuple(leaf.shape), leaf.dtype,
                                   leaf.device))
    _check_row(name, _tree_offsets(theta)[1])
    eps_vec = torch.as_tensor(eps, dtype=torch.float32).reshape(-1)
    if eps_vec.numel() != 1:
        raise ValueError("{}: eps must be a scalar; got {} entries".format(
            name, eps_vec.numel()))
    return eps_vec


def _tree_offsets(theta):
    """Each leaf's first element in a chain's unpadded row (the dict's
    order) and the row's length."""
    offsets, start = {}, 0
    for key, leaf in theta.items():
        offsets[key] = start
        start += math.prod(leaf.shape[1:])
    return offsets, start


def slim_sghmc_update_tree_ref(theta, v, grad, minv, eps, seed, mdecay=0.05,
                               scale_grad=1.0, prior_scale=0.0, noise=None,
                               emit_bf16=False, step=0):
    """Plain PyTorch version of :func:`slim_sghmc_update_tree`."""
    name = "slim_sghmc_update_tree"
    eps_vec = _check_tree(name, theta, v, grad, minv, eps, seed, noise)
    first = next(iter(theta.values()))
    offsets, width = _tree_offsets(theta)
    eta = None if noise is not None else philox_normals(
        seed, step, first.shape[0], width, first.device)
    # (eps, eps_s) as 0-d tensors, which broadcast over a leaf of any shape
    row = [r.reshape(()) for r in _sghmc_row(eps_vec, scale_grad,
                                              first.device)]
    theta_out, v_out = {}, {}
    for key, t in theta.items():
        if noise is not None:
            e = noise[key]
        else:
            size = math.prod(t.shape[1:])
            e = eta[:, offsets[key]:offsets[key] + size].reshape(t.shape)
        gg = grad[key].float() + prior_scale * t
        v_out[key] = _sghmc_velocity(v[key], minv[key], gg, e, row, mdecay)
        theta_out[key] = t + v_out[key]
    if emit_bf16:
        return theta_out, v_out, {key: t.to(torch.bfloat16)
                                  for key, t in theta_out.items()}
    return theta_out, v_out


def slim_sghmc_update_tree(theta, v, grad, minv, eps, seed, mdecay=0.05,
                           scale_grad=1.0, prior_scale=0.0, noise=None,
                           emit_bf16=False, step=0):
    """One SGHMC sampling step over a stacked parameter dict (B7'), every
    leaf in its own shape, with a frozen ``minv``.

    ``theta``, ``v``, ``minv`` (and ``noise``, injected normals, where
    given) are dicts of float32 leaves ``(n_chains, *shape)`` with theta's
    keys, ``grad`` the same in float32 or bfloat16; ``eps`` a scalar,
    ``seed`` and ``step`` as :func:`slim_sghmc_update`.  The normal of an
    element is the stream's at its index in the chain's unpadded row, the
    leaves in ``theta``'s order, which is what the lanes drivers draw for
    it.  Returns ``(theta', v')``, with ``emit_bf16`` also theta' rounded
    to bfloat16 (the next gradient pass's input), each a dict in theta's
    order.  CUDA tensors make one launch for all leaves; CPU tensors run
    :func:`slim_sghmc_update_tree_ref`.
    """
    name = "slim_sghmc_update_tree"
    first = next(iter(theta.values()), None) if isinstance(theta, dict) \
        else None
    if first is None or not _require_device(name, first):
        return slim_sghmc_update_tree_ref(theta, v, grad, minv, eps, seed,
                                          mdecay, scale_grad, prior_scale,
                                          noise, emit_bf16, step)
    eps_vec = _check_tree(name, theta, v, grad, minv, eps, seed, noise)
    from pysgmcmc_tpu_torch.ops import _build

    n = first.shape[0]
    offsets, width = _tree_offsets(theta)
    theta_out, v_out, bf16_out, table = {}, {}, {}, []
    for key, t in theta.items():
        ops = (t, v[key], grad[key], minv[key],
               None if noise is None else noise[key])
        if any(op is not None and not op.is_contiguous() for op in ops):
            raise ValueError("{}: CUDA operands must be contiguous".format(
                name))
        theta_out[key] = torch.empty_like(t)
        v_out[key] = torch.empty_like(t)
        if emit_bf16:
            bf16_out[key] = torch.empty_like(t, dtype=torch.bfloat16)
        table.append([_ptr(op) or 0 for op in ops] + [
            theta_out[key].data_ptr(), v_out[key].data_ptr(),
            bf16_out[key].data_ptr() if emit_bf16 else 0,
            offsets[key], math.prod(t.shape[1:])])
    # pinned and copied without waiting for the stream: the launch stays
    # behind the work already queued
    table = torch.tensor(table, dtype=torch.int64, pin_memory=True).to(
        first.device, non_blocking=True)
    lib = _build.load("slim_update")
    with torch.cuda.device(first.device):
        _build.check(lib.slim_sghmc_update_tree_launch(
            table.data_ptr(), len(theta), n, width, int(seed),
            int(step) & _MASK32, float(eps_vec[0]), _sqrt_sg(scale_grad),
            float(mdecay), float(prior_scale),
            int(next(iter(grad.values())).dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "slim_update")
    slim_sghmc_update_tree.launches += 1
    if emit_bf16:
        return theta_out, v_out, bf16_out
    return theta_out, v_out


slim_sghmc_update_tree.launches = 0


def slim_sgld_update(theta, grad, minv, mask, eps, seed, a_coef=1.0,
                     scale_grad=1.0, prior_scale=0.0, noise=None, step=0):
    """One SGLD sampling step over packed state with a frozen ``minv``
    (B8-sgld).  Arguments as :func:`slim_sghmc_update`, with ``a_coef``
    (the sampler's ``A``) for ``mdecay`` and no momentum; returns
    ``theta'``.  CPU tensors run :func:`slim_sgld_update_ref`."""
    name = "slim_sgld_update"
    if not _require_device(name, theta):
        return slim_sgld_update_ref(theta, grad, minv, mask, eps, seed,
                                    a_coef, scale_grad, prior_scale, noise,
                                    step)
    eps_vec = _validate(name, theta, [minv], grad, mask, eps, seed, noise)
    a_coef, c = _sgld_constants(a_coef, scale_grad, False)
    (out,) = _launch(name, dict(theta=theta, minv=minv, grad=grad),
                     ("theta",), eps_vec, noise, seed, step, prior_scale,
                     coef=a_coef, cdiv=c)
    slim_sgld_update.launches += 1
    return out


slim_sgld_update.launches = 0


def slim_psgld_update(theta, v, grad, mask, eps, seed, alpha=0.99,
                      lambda_reg=1e-5, scale_grad=1.0, prior_scale=0.0,
                      noise=None, step=0):
    """One pSGLD step over packed state (B8-psgld): the RMSprop accumulator
    ``v`` adapts, then the preconditioned Langevin update.  Arguments as
    :func:`slim_sghmc_update` with the sampler's ``alpha`` and
    ``lambda_reg``; returns ``(theta', v')``.  CPU tensors run
    :func:`slim_psgld_update_ref`."""
    name = "slim_psgld_update"
    if not _require_device(name, theta):
        return slim_psgld_update_ref(theta, v, grad, mask, eps, seed, alpha,
                                     lambda_reg, scale_grad, prior_scale,
                                     noise, step)
    eps_vec = _validate(name, theta, [v], grad, mask, eps, seed, noise)
    out = _launch(name, dict(theta=theta, v=v, grad=grad), ("theta", "v"),
                  eps_vec, noise, seed, step, prior_scale, coef=alpha,
                  cdiv=lambda_reg, c2=1.0 / scale_grad)
    slim_psgld_update.launches += 1
    return out


slim_psgld_update.launches = 0


def slim_rsghmc_update(theta, p, grad, mask, eps, seed, d_coef=1.0, bhat=0.0,
                       mass=1.0, speed_of_light=1.0, prior_scale=0.0,
                       noise=None, step=0):
    """One relativistic SGHMC step over packed state (B8-rsghmc) with the
    relativistic momentum ``p``; ``d_coef``/``bhat``/``mass``/
    ``speed_of_light`` are the sampler's ``D``/``Bhat``/``m``/``c``, other
    arguments as :func:`slim_sghmc_update`.  Returns ``(theta', p')``.  CPU
    tensors run :func:`slim_rsghmc_update_ref`."""
    name = "slim_rsghmc_update"
    if not _require_device(name, theta):
        return slim_rsghmc_update_ref(theta, p, grad, mask, eps, seed, d_coef,
                                      bhat, mass, speed_of_light,
                                      prior_scale, noise, step)
    eps_vec = _validate(name, theta, [p], grad, mask, eps, seed, noise)
    out = _launch(name, dict(theta=theta, v=p, grad=grad), ("theta", "v"),
                  eps_vec, noise, seed, step, prior_scale, coef=d_coef,
                  cdiv=bhat, c2=1.0 / mass,
                  c3=1.0 / (mass**2 * speed_of_light**2))
    slim_rsghmc_update.launches += 1
    return out


slim_rsghmc_update.launches = 0


def slim_sgnht_update(theta, p, grad, mask, xi, eps, seed, a_diff=1.0,
                      scale_grad=1.0, prior_scale=0.0, noise=None, step=0):
    """One SGNHT step over packed state (B8-sgnht) with momentum ``p`` and
    the per-chain thermostat ``xi`` (float32 ``(n_chains,)``); ``a_diff`` is
    the sampler's ``A``, other arguments as :func:`slim_sghmc_update`.
    Returns ``(theta', p')``; the driver updates ``xi`` from ``p'``.  CPU
    tensors run :func:`slim_sgnht_update_ref`."""
    name = "slim_sgnht_update"
    if not _require_device(name, theta):
        return slim_sgnht_update_ref(theta, p, grad, mask, xi, eps, seed,
                                     a_diff, scale_grad, prior_scale, noise,
                                     step)
    eps_vec = _validate(name, theta, [p], grad, mask, eps, seed, noise)
    _check_xi(name, theta, xi)
    out = _launch(name, dict(theta=theta, v=p, grad=grad, xi=xi),
                  ("theta", "v"), eps_vec, noise, seed, step, prior_scale,
                  coef=2.0 * a_diff, cdiv=scale_grad)
    slim_sgnht_update.launches += 1
    return out


slim_sgnht_update.launches = 0


def slim_sghmc_burnin_update(theta, v, tau, g, v_hat, grad, mask, eps, seed,
                             mdecay=0.05, scale_grad=1.0, prior_scale=0.0,
                             noise=None, step=0):
    """One SGHMC burn-in step over packed state (B9-sghmc): the EMAs and
    ``minv = 1/sqrt(old v_hat)``, then the update of
    :func:`slim_sghmc_update` with that ``minv``.  Returns ``(theta', v',
    tau', g', v_hat', minv_used)``; after the last burn-in step
    ``minv_used`` is what the sampling phase freezes.  CPU tensors run
    :func:`slim_sghmc_burnin_update_ref`."""
    name = "slim_sghmc_burnin_update"
    if not _require_device(name, theta):
        return slim_sghmc_burnin_update_ref(
            theta, v, tau, g, v_hat, grad, mask, eps, seed, mdecay,
            scale_grad, prior_scale, noise, step)
    eps_vec = _validate(name, theta, [v], grad, mask, eps, seed, noise,
                        f32_state=[tau, g, v_hat])
    out = _launch(name, dict(theta=theta, v=v, tau=tau, g=g, v_hat=v_hat,
                             grad=grad),
                  ("theta", "v", "tau", "g", "v_hat", "minv"), eps_vec, noise,
                  seed, step, prior_scale, sqrt_sg=_sqrt_sg(scale_grad),
                  coef=mdecay)
    slim_sghmc_burnin_update.launches += 1
    return out


slim_sghmc_burnin_update.launches = 0


def slim_sgld_burnin_update(theta, tau, g, v_hat, grad, mask, eps, seed,
                            a_coef=1.0, scale_grad=1.0, prior_scale=0.0,
                            noise=None, step=0):
    """One SGLD burn-in step over packed state (B9-sgld): the EMAs of
    :func:`slim_sghmc_burnin_update`, then ``theta += -eps minv A g +
    sqrt(max(2 eps (minv A) / sg_safe, 0)) eta`` with ``sg_safe =
    scale_grad + 2 sign(scale_grad) 1e-16 + 1e-16``.  Returns ``(theta',
    tau', g', v_hat', minv_used)``.  CPU tensors run
    :func:`slim_sgld_burnin_update_ref`."""
    name = "slim_sgld_burnin_update"
    if not _require_device(name, theta):
        return slim_sgld_burnin_update_ref(
            theta, tau, g, v_hat, grad, mask, eps, seed, a_coef, scale_grad,
            prior_scale, noise, step)
    eps_vec = _validate(name, theta, [], grad, mask, eps, seed, noise,
                        f32_state=[tau, g, v_hat])
    a_coef, c = _sgld_constants(a_coef, scale_grad, True)
    out = _launch(name, dict(theta=theta, tau=tau, g=g, v_hat=v_hat,
                             grad=grad),
                  ("theta", "tau", "g", "v_hat", "minv"), eps_vec, noise,
                  seed, step, prior_scale, coef=a_coef, cdiv=c)
    slim_sgld_burnin_update.launches += 1
    return out


slim_sgld_burnin_update.launches = 0


__all__ = [
    "slim_sghmc_update_tree",
    "slim_sghmc_update_tree_ref",
    "slim_psgld_update",
    "slim_psgld_update_ref",
    "slim_rsghmc_update",
    "slim_rsghmc_update_ref",
    "slim_sghmc_burnin_update",
    "slim_sghmc_burnin_update_ref",
    "slim_sghmc_update",
    "slim_sghmc_update_ref",
    "slim_sgld_burnin_update",
    "slim_sgld_burnin_update_ref",
    "slim_sgld_update",
    "slim_sgld_update_ref",
    "slim_sgnht_update",
    "slim_sgnht_update_ref",
]
