"""flash-SGHMC, flash-SGLD, pSGLD, SGNHT and relativistic SGHMC on Hopper:
whole BNN sampler steps per kernel launch.

PyTorch port of the fused kernels of :mod:`pysgmcmc_tpu.ops.fused_step`.
Each wrapper launches a hand-written CUDA kernel of ``csrc/fused_step.cu``
on CUDA tensors and runs its plain PyTorch version (``*_ref``) on CPU
tensors; any other device raises, and nothing falls back from a kernel to
its plain version.

- B1 :func:`fused_bnn_multistep` / B2 :func:`fused_bnn_multistep_burnin`:
  k SGHMC sampling / self-tuning burn-in steps per launch.
- B5-sgld :func:`fused_bnn_multistep_sgld` / B6
  :func:`fused_bnn_multistep_burnin_sgld`: the same for SGLD.
- B5-psgld :func:`fused_bnn_multistep_psgld`, B5-sgnht
  :func:`fused_bnn_multistep_sgnht`, B5-rsghmc
  :func:`fused_bnn_multistep_rsghmc`: k steps of pSGLD (RMSprop
  accumulator ``v``), SGNHT (momentum and a per-chain thermostat ``xi``,
  ``(n_chains,)``) and relativistic SGHMC; these samplers have no burn-in
  phase.
- B3 :func:`fused_bnn_step` / B4-sgld :func:`fused_bnn_step_sgld` /
  B4-psgld :func:`fused_bnn_step_psgld` / B4-sgnht
  :func:`fused_bnn_step_sgnht` / B4-rsghmc :func:`fused_bnn_step_rsghmc`:
  one step on each chain's pre-gathered minibatch (:func:`gather_batch`),
  with injected or Philox noise.
- Each step: take a minibatch window, forward through the dense tanh
  network, heteroscedastic Gaussian NLL plus the log-variance prior,
  hand-written backward pass, Gaussian weight-prior fold ``g + prior_scale *
  theta``, noise, update.  The semantics are the JAX kernels' at the level
  of unpacked parameters; the TPU slab layout does not carry over.

State layout: each chain's parameters are one contiguous float32 vector in
the order of :class:`FusedLayout` (``w1, b1, w2, b2, ..., w_head, b_head,
log_variance_bias``; matrices row-major ``(in, out)``), so state is
``(n_chains, P)``.  :func:`pack` / :func:`unpack` convert from and to the
dict of tensors.

bf16 state, as JAX's ``state_dtype=jnp.bfloat16``: theta is float32, and the
momentum (SGHMC, SGNHT, relativistic SGHMC) or the accumulator (B4-psgld)
is stored in ``state_dtype``, which the wrapper's ``v`` must have and its
``v'`` keeps; the frozen ``minv`` of SGHMC and SGLD may be float32 or
bfloat16.  The arithmetic is float32.  The new momentum is rounded to bf16
(to nearest even) after every step, as the TPU kernels write it back to its
bf16 ref after every inner step, while theta moves by the unrounded value
and SGNHT's ``p'^T p'`` sums the unrounded values; so two launches of k
steps equal one of 2k.  The burn-in's tau, g, v_hat and minv, pSGLD's
multi-step accumulator and everything of B6 stay float32.

Placement: a launch keeps each chain's P-long arrays in its block's shared
memory where they fit, by the library's own count (:func:`fused_placement`),
and otherwise in a device-memory workspace the wrapper allocates, with the
same kernel body (the burn-in's tau, g and v_hat stay in the output arrays
in device memory in both); so every hidden width JAX's fused path takes (up to
:data:`MAX_HIDDEN`) runs.  :data:`placements` counts the launches of each
kernel by C entry (one per variant: Box-Muller, CLT, paired) and
placement; :func:`variant_launches` sums a variant's.

Randomness: Philox4x32-10 keyed by a 64-bit seed, counter ``(chain,
absolute step, draw, purpose)``, with uniforms ``u = ((bits >> 8) + 1) *
2**-24`` in (0, 1]; the window index is ``min(floor(u * n_windows),
n_windows - 1)``.  Normals come from one of JAX's two generators,
``noise_impl``: ``"box_muller"`` (the kernels' default, as JAX's), four
normals from each draw (element ``e`` a quarter of draw ``e // 4``,
:func:`philox_normals`), or ``"hadamard_clt"``, the MXU-CLT
generator (:func:`clt_normals`: ``bf16(u - 1/2) H_n sqrt(12 / n)`` over
groups of n uniforms in the slot geometry of JAX's ``_block_etas``), the
default of JAX's drivers on the chip; each kernel has one instantiation per
generator (``csrc/fused_step.cu``, ``csrc/fused_step_clt.cu``).  The plain
versions implement the same stream with int64 arithmetic, so one launch of
``2k`` steps equals two launches of ``k``, and k one-step launches on the
windows of :func:`philox_windows` equal one multi-step launch.  For tests,
the Box-Muller kernels also take ``noise`` (``(k, n_chains, P)``;
``(n_chains, P)`` for the one-step kernels) and ``widx`` ``(k, n_chains)``
to read instead of drawing; as in JAX, injected noise does not combine with
``"hadamard_clt"``.

``pair_dots=True`` (B1, B2, B3, B5-*, B6; JAX's chain-pair kernels, whose
block-diagonal pairs are an MXU layout): the paired instantiations
(``csrc/fused_step_paired.cu``) draw every normal and window as the
unpaired ones, and at bf16 state keep the momentum of the matrix slabs
(``w2, b2, ..., wD, bD``) float32 for the whole launch, rounding it once at
its end; the vector rows round every step.  At float32 state they equal the
unpaired kernels bit for bit.  They take what JAX's take: Box-Muller, the
64-slot layout (``h <= 50``), depth 3, an even number of chains, and for
B3 one input and no injected noise.

Examples
--------
>>> import torch
>>> lay = FusedLayout(n_inputs=1, hidden=50, depth=3)
>>> lay.n_params
5252
>>> x = torch.arange(6.0).reshape(6, 1)
>>> x_win, y_win = data_windows(x, x[:, 0], 4)
>>> x_win.tolist()
[[0.0, 1.0, 2.0, 3.0], [1.0, 2.0, 3.0, 4.0], [2.0, 3.0, 4.0, 5.0]]
>>> gather_batch(x_win, y_win, torch.tensor([2, 0]))[1].tolist()
[[2.0, 3.0, 4.0, 5.0], [0.0, 1.0, 2.0, 3.0]]
"""

import collections
import functools
import math
from typing import NamedTuple

import torch

LOG_MP = math.log(1e-6)   # log-variance prior mean (reference)
VAR_P = 0.01              # log-variance prior variance
MIN_DEPTH, MAX_DEPTH = 2, 4
MAX_INPUTS = 4
# the widest hidden layer of JAX's fused kernels (its 128-slot layout,
# fused_slot); the port's kernels have no slots but keep the domain
MAX_HIDDEN = 114
STATE_DTYPES = (torch.float32, torch.bfloat16)
F32 = (torch.float32,)

PURPOSE_WINDOW, PURPOSE_NOISE, PURPOSE_CLT = 0, 1, 2
NOISE_IMPLS = ("box_muller", "hadamard_clt")
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


#  Layout ---------------------------------------------------------------------

class FusedLayout(NamedTuple):
    """Flat per-chain parameter layout of the dense network family."""

    n_inputs: int
    hidden: int
    depth: int

    def entries(self):
        """``[(name, shape), ...]`` in storage order."""
        h, head = self.hidden, self.depth + 1
        w1 = (h,) if self.n_inputs == 1 else (self.n_inputs, h)
        out = [("w1", w1), ("b1", (h,))]
        for layer in range(2, head):
            out += [("w{}".format(layer), (h, h)), ("b{}".format(layer), (h,))]
        out += [("w{}".format(head), (h,)), ("b{}".format(head), (1,)),
                ("log_variance_bias", (1, 1))]
        return out

    def offsets(self):
        """``{name: (offset, shape)}``."""
        out, offset = {}, 0
        for name, shape in self.entries():
            out[name] = (offset, shape)
            offset += math.prod(shape)
        return out

    @property
    def n_params(self):
        return sum(math.prod(shape) for _, shape in self.entries())


def check_hidden(hidden):
    """Raise ``ValueError`` beyond the widest hidden layer of JAX's fused
    kernels (:data:`MAX_HIDDEN`, with JAX's ``fused_slot`` message)."""
    if hidden > MAX_HIDDEN:
        raise ValueError(
            "fused kernels support hidden widths up to {} (got {}); use the "
            "chains-on-lanes path for wider networks".format(MAX_HIDDEN,
                                                             hidden))


def fused_layout(params):
    """The :class:`FusedLayout` of a stacked dense-network dict (leaves
    ``(n_chains, ...)``); raises outside the fused family's domain."""
    depth = sum(1 for k in params if k.startswith("w")) - 1
    if not MIN_DEPTH <= depth <= MAX_DEPTH:
        raise ValueError(
            "fused kernels support {}-{} hidden dense layers; got a "
            "{}-hidden-layer network".format(MIN_DEPTH, MAX_DEPTH, depth))
    hidden = params["w2"].shape[-1]
    check_hidden(hidden)
    if any(params["w{}".format(i)].shape[-2:] != (hidden, hidden)
           for i in range(2, depth + 1)):
        raise ValueError("fused kernels require equal hidden widths")
    w1 = params["w1"]
    n_inputs = 1 if w1.ndim == 2 else w1.shape[-2]
    if not 1 <= n_inputs <= MAX_INPUTS:
        raise ValueError(
            "fused kernels support 1..{} input features; got {}".format(
                MAX_INPUTS, n_inputs))
    return FusedLayout(n_inputs, hidden, depth)


def layout_for(n_params, n_inputs, hidden):
    """The layout of ``n_params``-long chain vectors (solves for depth)."""
    for depth in range(MIN_DEPTH, MAX_DEPTH + 1):
        lay = FusedLayout(n_inputs, hidden, depth)
        if lay.n_params == n_params:
            return lay
    raise ValueError(
        "no dense network with {} input(s), width {} and {}-{} hidden layers "
        "has {} parameters".format(n_inputs, hidden, MIN_DEPTH, MAX_DEPTH,
                                   n_params))


def pack(params, layout):
    """Stacked dict (leaves ``(n_chains, ...)``) -> ``(n_chains, P)`` float32."""
    n = params["w1"].shape[0]
    return torch.cat(
        [params[name].reshape(n, -1).to(torch.float32)
         for name, _ in layout.entries()], dim=1).contiguous()


def unpack(flat, layout):
    """``(n_chains, P)`` -> stacked dict of views into ``flat``."""
    n = flat.shape[0]
    return {
        name: flat[:, off:off + math.prod(shape)].reshape((n,) + shape)
        for name, (off, shape) in layout.offsets().items()
    }


#  Windows --------------------------------------------------------------------

def data_windows(x, y, batch_size):
    """Contiguous minibatch windows: ``x_win[w, b] = x[w + b]``.

    Returns ``(x_win, y_win)`` with ``n_windows = n - batch_size + 1``:
    ``x_win`` is ``(n_windows, batch_size)`` for one input feature and
    ``(n_windows, batch_size, n_inputs)`` otherwise, ``y_win`` is
    ``(n_windows, batch_size)``, both float32 on ``x``'s device.  The JAX
    version pads the batch axis to the TPU kernel's 24 rows; the port does
    not.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim == 1:
        x = x[:, None]
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device).reshape(-1)
    n = x.shape[0]
    if not 1 <= batch_size <= n:
        raise ValueError(
            "data_windows: batch_size {} must lie in [1, {}]".format(
                batch_size, n))
    n_windows = n - batch_size + 1
    idx = (torch.arange(n_windows, device=x.device)[:, None]
           + torch.arange(batch_size, device=x.device)[None, :])
    x_win = x[idx]
    if x.shape[1] == 1:
        x_win = x_win[:, :, 0]
    return x_win.contiguous(), y[idx].contiguous()


#  Philox4x32-10 in int64 arithmetic -------------------------------------------

def _mulhilo(a, m):
    """``(hi, lo)`` 32-bit words of ``a * m`` for uint32 ``a`` (int64 tensor
    or int) and constant ``m``, without overflowing int64."""
    t = a * (m & 0xFFFF)          # < 2**48
    u = a * (m >> 16)             # < 2**48
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al. 2011) on uint32 words held in int64.

    ``counter`` is four broadcastable int64 tensors (or ints), ``key`` two
    ints; returns the four output words as int64 tensors.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits):
    """uint32 words (int64) -> float32 uniforms in (0, 1], exactly."""
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)


def _seed_key(seed):
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError("seed must lie in [0, 2**64); got {}".format(seed))
    return seed & _MASK32, seed >> 32


def philox_windows(seed, step, n_chains, n_windows, device):
    """Each chain's window index at absolute ``step`` (int64, ``(n_chains,)``)."""
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)
    bits = philox4x32_10((chain, step & _MASK32, 0, PURPOSE_WINDOW),
                         _seed_key(seed))[0]
    u = bits_to_uniform(bits)
    return torch.clamp((u * n_windows).to(torch.int64), max=n_windows - 1)


def philox_normals(seed, step, n_chains, n_params, device, elements=None):
    """The ``(n_chains, n_params)`` standard normals of absolute ``step``:
    each chain's elements ``0 .. n_params - 1``, or those of the
    ``(n_params,)`` integer tensor ``elements``.

    Element ``e`` takes a quarter of draw ``e // 4``: Box-Muller on words
    ``(x, y)`` gives ``r cos t`` and ``r sin t`` for elements ``4q`` and
    ``4q + 1``, on words ``(z, w)`` for ``4q + 2`` and ``4q + 3``."""
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)[:, None]
    if elements is None:
        element = torch.arange(n_params, dtype=torch.int64, device=device)
    else:
        element = elements.to(device=device, dtype=torch.int64)
    draws, inverse = torch.unique(element >> 2, return_inverse=True)
    r = [bits_to_uniform(w) for w in philox4x32_10(
        (chain, step & _MASK32, draws[None, :], PURPOSE_NOISE),
        _seed_key(seed))]
    quads = []  # the (n_chains, draws) normals of each quarter of a draw
    for u1, u2 in ((r[0], r[1]), (r[2], r[3])):
        radius, angle = torch.sqrt(-2.0 * torch.log(u1)), 2.0 * math.pi * u2
        quads += [radius * torch.cos(angle), radius * torch.sin(angle)]
    return torch.stack(quads, dim=-1)[:, inverse, element & 3]


#  The MXU-CLT generator (JAX's _normal_clt) ----------------------------------

def clt_slot(hidden):
    """``(s, bias_row)`` of JAX's slot layout for hidden width ``hidden``
    (its ``fused_slot``): ``(64, 50)`` up to 50, ``(128, 114)`` above."""
    check_hidden(hidden)
    return (64, 50) if hidden <= 50 else (128, 114)


def fwht(x):
    """``x @ H_n`` along the last axis (n a power of two), ``H_n`` the
    +-1 Sylvester-Hadamard matrix, as the CLT kernels compute it: a fast
    Walsh-Hadamard transform with stages of stride 1, 2, 4, ... in that
    order, each taking the pair ``(a, b)`` at ``(i, i + stride)`` to ``(a +
    b, a - b)``.  The same float32 additions in the same order, so the card
    and the CPU give the same bits."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < n:
        y = x.reshape(*lead, n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        h *= 2
    return x


@functools.lru_cache(maxsize=None)
def _clt_sections(layout):
    """The slot geometry of JAX's ``_block_etas`` for ``layout``: a list of
    ``(first slot, element map)``, one per array it draws (each pair of
    matrix slabs ``(s, 2s)``, an odd last matrix ``(s, s)``, the 8 vector
    rows ``(8, s)``), in slot order.  The map gives each slot's element in
    the flat vector, -1 where the slot is dead: in a matrix slab row ``r <
    H`` is ``w[r, :]`` and the bias rides row ``bias_row``; the vector rows
    are ``w1`` (one row per input), ``b1``, ``w_head``, then ``b_head`` and
    ``log_variance_bias`` at lanes 0 and 1."""
    s, bias_row = clt_slot(layout.hidden)
    h, k = layout.hidden, layout.n_inputs
    off = {name: o for name, (o, _) in layout.offsets().items()}
    head = layout.depth + 1

    def slab(layer):
        m = torch.full((s, s), -1, dtype=torch.int64)
        m[:h, :h] = off["w{}".format(layer)] + torch.arange(h * h).reshape(
            h, h)
        m[bias_row, :h] = off["b{}".format(layer)] + torch.arange(h)
        return m

    mats = [slab(layer) for layer in range(2, head)]
    vec = torch.full((8, s), -1, dtype=torch.int64)
    vec[:k, :h] = off["w1"] + torch.arange(k * h).reshape(k, h)
    vec[k, :h] = off["b1"] + torch.arange(h)
    vec[k + 1, :h] = off["w{}".format(head)] + torch.arange(h)
    vec[k + 2, :2] = off["b{}".format(head)] + torch.arange(2)  # b_head, lvb
    arrays = [torch.cat(mats[i:i + 2], dim=1)
              for i in range(0, len(mats) - 1, 2)]
    if len(mats) % 2:
        arrays.append(mats[-1])
    arrays.append(vec)
    sections, slot = [], 0
    for emap in arrays:
        sections.append((slot, emap))
        slot += emap.numel()
    return sections


def clt_slots(layout):
    """Uniforms one chain draws per step in the CLT geometry (dead slots
    included): ``(depth - 1) s^2 + 8 s``."""
    return sum(emap.numel() for _, emap in _clt_sections(layout))


def clt_normals(seed, step, n_chains, layout, device, uniforms=None):
    """The ``(n_chains, P)`` MXU-CLT normals of absolute ``step`` (JAX's
    ``_normal_clt`` in the geometry of ``_block_etas``, gathered into the
    flat layout).

    Each array of :func:`_clt_sections` is a set of rows, each a group of
    ``n`` uniforms (its width: ``2s`` for a pair of matrix slabs, ``s``
    otherwise), and each group gives ``n`` normals ``z = fwht(bf16(u -
    1/2)) * sqrt(12 / n)`` (:func:`fwht`; the bf16 rounding to nearest
    even).  The uniforms of a group whose first slot is ``q`` are the four
    words of the ``n / 4`` Philox draws at counter ``(chain, step, q / 4 +
    e, PURPOSE_CLT)``, word ``w`` giving lane ``w n / 4 + e``; the kernels
    draw only the rows that hold values, and so does this.  ``uniforms``
    ``(n_chains, clt_slots(layout))`` float32, in slot order, replaces the
    draws (as JAX's uniforms, for tests)."""
    out = torch.empty((n_chains, layout.n_params), dtype=torch.float32,
                      device=device)
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)
    for slot, emap in _clt_sections(layout):
        rows_all, n = emap.shape
        live = torch.nonzero((emap >= 0).any(dim=1))[:, 0]
        emap = emap[live].to(device)
        live = live.to(device)
        if uniforms is None:
            q = n // 4
            ctr = ((slot + live[:, None] * n) // 4
                   + torch.arange(q, dtype=torch.int64, device=device))
            words = philox4x32_10(
                (chain[:, None, None], step & _MASK32, ctr[None],
                 PURPOSE_CLT), _seed_key(seed))
            u = bits_to_uniform(torch.stack(words, dim=-2)).reshape(
                n_chains, -1, n)
        else:
            u = uniforms[:, slot:slot + rows_all * n].reshape(
                n_chains, rows_all, n)[:, live].to(device)
        x = (u - 0.5).to(torch.bfloat16).to(torch.float32)
        z = fwht(x) * torch.tensor(math.sqrt(12.0 / n), dtype=torch.float32,
                                   device=device)
        keep = emap >= 0
        out[:, emap[keep]] = z[:, keep]
    return out


def _step_normals(noise_impl, seed, step, n_chains, layout, device):
    """The ``(n_chains, P)`` normals of absolute ``step`` from the
    generator ``noise_impl`` (:data:`NOISE_IMPLS`)."""
    if noise_impl == "hadamard_clt":
        return clt_normals(seed, step, n_chains, layout, device)
    return philox_normals(seed, step, n_chains, layout.n_params, device)


#  Plain versions ---------------------------------------------------------------

def _fwd_bwd(theta, layout, xb, yb, inv_b, inv_n):
    """Forward + likelihood + backward for every chain.

    ``theta`` ``(n, P)``, ``xb`` ``(n, B, n_inputs)``, ``yb`` ``(n, B)``.
    Returns ``(cost (n, 1), grad (n, P))``; the gradient excludes the
    Gaussian weight prior (the update folds it in).
    """
    n = theta.shape[0]
    p = unpack(theta, layout)
    head = layout.depth + 1
    acts = [torch.tanh(
        torch.bmm(xb, p["w1"].reshape(n, layout.n_inputs, layout.hidden))
        + p["b1"][:, None, :])]
    for layer in range(2, head):
        acts.append(torch.tanh(
            torch.bmm(acts[-1], p["w{}".format(layer)])
            + p["b{}".format(layer)][:, None, :]))
    a_last = acts[-1]
    w_head = p["w{}".format(head)]
    f_mean = (torch.bmm(a_last, w_head[:, :, None])[:, :, 0]
              + p["b{}".format(head)])
    lvb = p["log_variance_bias"].reshape(n, 1)

    e_lv = torch.exp(lvb)
    var_inv = 1.0 / (e_lv + 1e-16)
    diff = f_mean - yb
    mse = diff * diff
    ll = torch.sum(-mse * (0.5 * var_inv) - 0.5 * lvb, dim=1,
                   keepdim=True) * inv_b
    dev = lvb - LOG_MP
    p_term = -(dev * dev) / (2.0 * VAR_P) - 0.5 * math.log(VAR_P)
    cost = -(ll + p_term * inv_n)
    d_mean = diff * var_inv * inv_b
    d_lvb = (-torch.sum(mse * (0.5 * e_lv) * (var_inv * var_inv) - 0.5,
                        dim=1, keepdim=True) * inv_b
             + dev / VAR_P * inv_n)

    grads = {
        "w{}".format(head): torch.bmm(d_mean[:, None, :], a_last)[:, 0],
        "b{}".format(head): d_mean.sum(dim=1, keepdim=True),
        "log_variance_bias": d_lvb,
    }
    dz = (d_mean[:, :, None] * w_head[:, None, :]) * (1.0 - a_last * a_last)
    for layer in range(head - 1, 1, -1):
        a_in = acts[layer - 2]
        grads["w{}".format(layer)] = torch.bmm(a_in.transpose(1, 2), dz)
        grads["b{}".format(layer)] = dz.sum(dim=1)
        da = torch.bmm(dz, p["w{}".format(layer)].transpose(1, 2))
        dz = da * (1.0 - a_in * a_in)
    grads["w1"] = torch.bmm(xb.transpose(1, 2), dz)
    grads["b1"] = dz.sum(dim=1)
    return cost, pack(grads, layout)


def _windows_3d(x_win):
    return x_win[:, :, None] if x_win.ndim == 2 else x_win


def _step_inputs(t, step, seed, n, layout, x_win, noise, widx, device,
                 noise_impl):
    """Window rows and noise of step ``t`` (test inputs or the Philox
    stream, its normals from ``noise_impl``)."""
    if widx is not None:
        w = widx[t].to(torch.int64)
    else:
        w = philox_windows(seed, step, n, x_win.shape[0], device)
    if noise is not None:
        eta = noise[t]
    else:
        eta = _step_normals(noise_impl, seed, step, n, layout, device)
    return w, eta


def _sghmc_velocity(v, minv, gg, eta, row, mdecay, mask=None):
    """SGHMC momentum update (JAX ``_sghmc_rule``); ``row`` is ``(eps,
    eps / sqrt(scale_grad))``; a ``mask`` row multiplies the new momentum
    (JAX's ``slim_update._update_math``)."""
    eps_t, es = row[0], row[1]
    es2 = es * es
    sigma = torch.sqrt(torch.clamp(2.0 * es2 * mdecay * minv - es2 * es2,
                                   min=1e-16))
    v_new = v - eps_t * eps_t * minv * gg - mdecay * v + sigma * eta
    return v_new if mask is None else v_new * mask


def _sgld_delta(minv, gg, eta, eps, a_coef, c, burnin):
    """SGLD position increment (JAX ``_sgld_rule`` and
    ``_sgld_burnin_step_math``); ``(a_coef, c)`` come from
    :func:`_sgld_constants`.  The noise scales with ``eps``, not
    ``eps**2``."""
    if burnin:
        sigma = torch.sqrt(torch.clamp(2.0 * eps * ((minv * a_coef) / c),
                                       min=0.0))
    else:
        sigma = torch.sqrt(torch.clamp(2.0 * eps * minv * c, min=0.0))
    return -eps * minv * a_coef * gg + sigma * eta


def _adapt(tau, g, v_hat, gg):
    """The burn-in EMAs, all reading old values; returns ``(minv, tau', g',
    v_hat')`` with ``minv = 1/sqrt(old v_hat)`` (guarded)."""
    small = 1e-16
    sq = torch.sqrt(torch.clamp(v_hat, min=0.0))
    minv = 1.0 / (sq + 2.0 * torch.sign(sq) * small + small)
    denom = v_hat + 2.0 * torch.sign(v_hat) * small + small
    r = 1.0 / (tau + 1.0)
    return (minv, tau + (-g * g * tau) / denom + 1.0, g - r * g + r * gg,
            v_hat - r * v_hat + r * gg * gg)


def _psgld_update(theta, v, gg, eta, eps, alpha, lambda_reg, inv_sg):
    """pSGLD (JAX ``_psgld_rule``): the RMSprop accumulator adapts, then the
    preconditioned Langevin step; returns ``(theta', v')``."""
    v_new = alpha * v + (1.0 - alpha) * gg * gg
    precond = 1.0 / (lambda_reg + torch.sqrt(torch.clamp(v_new, min=0.0)))
    sigma = torch.sqrt(torch.clamp(eps * precond * inv_sg, min=0.0))
    return theta + (-0.5 * eps * precond * gg + sigma * eta), v_new


def _rsghmc_update(theta, p, gg, eta, eps, noise_scale, d_coef, inv_m,
                   inv_m2c2):
    """Relativistic SGHMC (JAX ``_rsghmc_rule``) on the log-likelihood
    gradient ``-gg``, with the velocity ``eps p / m / sqrt(p^2 / (m^2 c^2) +
    1)``; returns ``(theta', p')``."""
    def vel(pp):
        return eps * pp * inv_m * torch.rsqrt(pp * pp * inv_m2c2 + 1.0)

    p_new = p + eps * -gg + noise_scale * eta - d_coef * vel(p)
    return theta + vel(p_new), p_new


def _sgnht_update(theta, p, gg, eta, xi, eps, sigma):
    """SGNHT (JAX ``_sgnht_rule``) with one thermostat per chain row,
    ``xi`` ``(n_chains,)``; returns ``(theta', p')``."""
    p_new = p - xi[:, None] * eps * p - eps * gg + sigma * eta
    return theta + eps * p_new, p_new


def _masked(minv, x):
    return torch.where(minv > 0.0, x, torch.zeros_like(x))


def _stored(x, state_dtype, deferred=None):
    """``x`` as the kernels keep it between steps: rounded to bf16 (to
    nearest even) under bf16 state, held in float32; the columns of the
    ``deferred`` range ``(lo, hi)`` (the paired kernels' matrix slabs,
    :func:`_matrix_slabs`) stay unrounded until the launch ends."""
    if state_dtype == torch.float32:
        return x
    rounded = x.to(state_dtype).to(torch.float32)
    if deferred is None:
        return rounded
    lo, hi = deferred
    return torch.cat([rounded[:, :lo], x[:, lo:hi], rounded[:, hi:]], dim=1)


def _matrix_slabs(layout, pair_dots):
    """The flat columns ``(lo, hi)`` of the matrix slabs (``w2, b2, ...,
    wD, bD``) whose momentum the paired kernels round once per launch, or
    ``None`` unpaired."""
    if not pair_dots:
        return None
    off = layout.offsets()
    return (off["w2"][0], off["w{}".format(layout.depth + 1)][0])


def fused_bnn_multistep_ref(theta, v, minv, x_win, y_win, eps, seed,
                            mdecay=0.05, scale_grad=1.0, prior_scale=0.0,
                            batch_size=20, n_data=100,
                            state_dtype=torch.float32, k_steps=1, h=50,
                            pair_dots=False, noise_impl="box_muller",
                            step0=0, noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep` (same arguments,
    same result up to float32 summation order)."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep", theta,
        {"v": (v, (state_dtype,)), "minv": (minv, STATE_DTYPES)},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    tab = _sghmc_table(eps_vec, scale_grad)
    n = theta.shape[0]
    xw = _windows_3d(x_win)
    inv_b, inv_n = 1.0 / batch_size, 1.0 / n_data
    deferred = _matrix_slabs(layout, pair_dots)
    v, minv = v.float(), minv.float()
    cost = None
    for t in range(int(k_steps)):
        w, eta = _step_inputs(t, step0 + t, seed, n, layout, x_win, noise,
                              widx, theta.device, noise_impl)
        cost, grad = _fwd_bwd(theta, layout, xw[w], y_win[w], inv_b, inv_n)
        gg = grad + prior_scale * theta
        v_new = _masked(minv, _sghmc_velocity(v, minv, gg, eta, tab[t],
                                              mdecay))
        theta = theta + v_new
        v = _stored(v_new, state_dtype, deferred)
    return theta, v.to(state_dtype), cost


def fused_bnn_multistep_burnin_ref(theta, v, tau, g, v_hat, x_win, y_win,
                                   eps, seed, mdecay=0.05, scale_grad=1.0,
                                   prior_scale=0.0, batch_size=20,
                                   n_data=100, state_dtype=torch.float32,
                                   k_steps=1, h=50, pair_dots=False,
                                   noise_impl="box_muller", step0=0,
                                   noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep_burnin`."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep_burnin", theta,
        {"v": (v, (state_dtype,)), "tau": (tau, F32), "g": (g, F32),
         "v_hat": (v_hat, F32)},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    tab = _sghmc_table(eps_vec, scale_grad)
    n = theta.shape[0]
    xw = _windows_3d(x_win)
    inv_b, inv_n = 1.0 / batch_size, 1.0 / n_data
    deferred = _matrix_slabs(layout, pair_dots)
    v = v.float()
    cost = minv = None
    for t in range(int(k_steps)):
        w, eta = _step_inputs(t, step0 + t, seed, n, layout, x_win, noise,
                              widx, theta.device, noise_impl)
        cost, grad = _fwd_bwd(theta, layout, xw[w], y_win[w], inv_b, inv_n)
        gg = grad + prior_scale * theta
        minv, tau, g, v_hat = _adapt(tau, g, v_hat, gg)
        v_new = _sghmc_velocity(v, minv, gg, eta, tab[t], mdecay)
        theta = theta + v_new
        v = _stored(v_new, state_dtype, deferred)
    return theta, v.to(state_dtype), tau, g, v_hat, minv, cost


def fused_bnn_step_ref(theta, v, minv, x_sel, y_sel, eps, seed,
                       mdecay=0.05, scale_grad=1.0, prior_scale=0.0,
                       batch_size=20, n_data=100, state_dtype=torch.float32,
                       select_in_kernel=False, pair_dots=False, n_inputs=1,
                       h=50, noise_impl="box_muller", step=0, noise=None):
    """Plain PyTorch version of :func:`fused_bnn_step`."""
    if select_in_kernel:
        _check_selection("fused_bnn_step", noise, pair_dots)
        return fused_bnn_multistep_ref(
            theta, v, minv, x_sel, y_sel, eps, seed, mdecay, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, 1, h, pair_dots,
            noise_impl, step)
    layout, eps_vec = _validate(
        "fused_bnn_step", theta,
        {"v": (v, (state_dtype,)), "minv": (minv, STATE_DTYPES)},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, pair_dots,
        noise_impl, noise, None, n_inputs)
    eta = _one_step_noise(theta, layout, seed, step, noise, noise_impl)
    cost, grad = _fwd_bwd(theta, layout, _windows_3d(x_sel), y_sel,
                          1.0 / batch_size, 1.0 / n_data)
    gg = grad + prior_scale * theta
    minv = minv.float()
    v = _masked(minv, _sghmc_velocity(
        v.float(), minv, gg, eta, _sghmc_table(eps_vec, scale_grad)[0],
        mdecay))
    return theta + v, v.to(state_dtype), cost


def fused_bnn_step_sgld_ref(theta, minv, x_sel, y_sel, eps, seed,
                            a_coef=1.0, scale_grad=1.0, prior_scale=0.0,
                            batch_size=20, n_data=100, n_inputs=1, h=50,
                            noise_impl="box_muller", step=0, noise=None):
    """Plain PyTorch version of :func:`fused_bnn_step_sgld`."""
    layout, eps_vec = _validate(
        "fused_bnn_step_sgld", theta, {"minv": (minv, STATE_DTYPES)},
        x_sel, y_sel, eps, seed, batch_size, torch.float32, 1, h, False,
        noise_impl, noise, None, n_inputs)
    eta = _one_step_noise(theta, layout, seed, step, noise, noise_impl)
    cost, grad = _fwd_bwd(theta, layout, _windows_3d(x_sel), y_sel,
                          1.0 / batch_size, 1.0 / n_data)
    a_coef, c = _sgld_constants(a_coef, scale_grad, False)
    gg = grad + prior_scale * theta
    minv = minv.float()
    return theta + _masked(minv, _sgld_delta(minv, gg, eta, eps_vec[0],
                                             a_coef, c, False)), cost


def fused_bnn_multistep_sgld_ref(theta, minv, x_win, y_win, eps, seed,
                                 a_coef=1.0, scale_grad=1.0, prior_scale=0.0,
                                 batch_size=20, n_data=100, k_steps=1, h=50,
                                 pair_dots=False, noise_impl="box_muller",
                                 step0=0, noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep_sgld`."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep_sgld", theta, {"minv": (minv, STATE_DTYPES)},
        x_win, y_win, eps, seed, batch_size, torch.float32, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    a_coef, c = _sgld_constants(a_coef, scale_grad, False)
    minv = minv.float()
    n = theta.shape[0]
    xw = _windows_3d(x_win)
    inv_b, inv_n = 1.0 / batch_size, 1.0 / n_data
    cost = None
    for t in range(int(k_steps)):
        w, eta = _step_inputs(t, step0 + t, seed, n, layout, x_win, noise,
                              widx, theta.device, noise_impl)
        cost, grad = _fwd_bwd(theta, layout, xw[w], y_win[w], inv_b, inv_n)
        gg = grad + prior_scale * theta
        theta = theta + _masked(minv, _sgld_delta(minv, gg, eta, eps_vec[t],
                                                  a_coef, c, False))
    return theta, cost


def fused_bnn_multistep_burnin_sgld_ref(theta, tau, g, v_hat, x_win, y_win,
                                        eps, seed, a_coef=1.0,
                                        scale_grad=1.0, prior_scale=0.0,
                                        batch_size=20, n_data=100,
                                        k_steps=1, h=50, pair_dots=False,
                                        noise_impl="box_muller", step0=0,
                                        noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep_burnin_sgld`."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep_burnin_sgld", theta,
        {"tau": (tau, F32), "g": (g, F32), "v_hat": (v_hat, F32)},
        x_win, y_win, eps, seed, batch_size, torch.float32, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    a_coef, c = _sgld_constants(a_coef, scale_grad, True)
    n = theta.shape[0]
    xw = _windows_3d(x_win)
    inv_b, inv_n = 1.0 / batch_size, 1.0 / n_data
    cost = minv = None
    for t in range(int(k_steps)):
        w, eta = _step_inputs(t, step0 + t, seed, n, layout, x_win, noise,
                              widx, theta.device, noise_impl)
        cost, grad = _fwd_bwd(theta, layout, xw[w], y_win[w], inv_b, inv_n)
        gg = grad + prior_scale * theta
        minv, tau, g, v_hat = _adapt(tau, g, v_hat, gg)
        theta = theta + _sgld_delta(minv, gg, eta, eps_vec[t], a_coef, c,
                                    True)
    return theta, tau, g, v_hat, minv, cost


def _rule_steps(kind, theta, v, xi, layout, k_steps, step_inputs, tab,
                consts, prior_scale, batch_size, n_data,
                state_dtype=torch.float32, pair_dots=False):
    """``k_steps`` steps of pSGLD, SGNHT or relativistic SGHMC (``kind``
    ``"psgld"``, ``"sgnht"`` or ``"rsghmc"``), the samplers without a mass
    matrix.  Step ``t`` takes its minibatch rows and normals from
    ``step_inputs(t)``, its stepsize (and SGNHT's or relativistic SGHMC's
    noise scale) from row ``t`` of ``tab``, and the rule's constants from
    ``consts``, the kernel's ``coef``/``cdiv``/``c2``/``c3``.  SGNHT's
    thermostat then moves by ``eps (p'^T p' / P - 1)`` of the unrounded
    ``p'``; ``v`` is kept in ``state_dtype`` between steps (the matrix
    slabs' unrounded within the launch with ``pair_dots``).  Returns
    ``(theta', v' (in state_dtype), xi', cost)``."""
    inv_b, inv_n = 1.0 / batch_size, 1.0 / n_data
    deferred = _matrix_slabs(layout, pair_dots)
    v = v.float()
    cost = None
    for t in range(int(k_steps)):
        xb, yb, eta = step_inputs(t)
        cost, grad = _fwd_bwd(theta, layout, xb, yb, inv_b, inv_n)
        gg = grad + prior_scale * theta
        eps = tab[t, 0]
        if kind == "psgld":
            theta, v = _psgld_update(theta, v, gg, eta, eps, consts["coef"],
                                     consts["cdiv"], consts["c2"])
        elif kind == "rsghmc":
            theta, v = _rsghmc_update(theta, v, gg, eta, eps, tab[t, 1],
                                      consts["coef"], consts["c2"],
                                      consts["c3"])
        else:
            theta, v = _sgnht_update(theta, v, gg, eta, xi, eps, tab[t, 1])
            xi = xi + eps * (torch.sum(v * v, dim=1) * consts["c2"] - 1.0)
        v = _stored(v, state_dtype, deferred)
    return theta, v.to(state_dtype), xi, cost


def _window_inputs(seed, step0, layout, x_win, y_win, noise, widx, theta,
                   noise_impl):
    """``step_inputs`` of :func:`_rule_steps` on the shared window tables:
    the windows and normals of absolute step ``step0 + t``."""
    xw = _windows_3d(x_win)

    def step_inputs(t):
        w, eta = _step_inputs(t, step0 + t, seed, theta.shape[0], layout,
                              x_win, noise, widx, theta.device, noise_impl)
        return xw[w], y_win[w], eta
    return step_inputs


def _gathered_inputs(seed, step, layout, x_sel, y_sel, noise, theta,
                     noise_impl):
    """``step_inputs`` of :func:`_rule_steps` for one step on each chain's
    gathered rows."""
    eta = _one_step_noise(theta, layout, seed, step, noise, noise_impl)
    return lambda t: (_windows_3d(x_sel), y_sel, eta)


def fused_bnn_step_psgld_ref(theta, v, x_sel, y_sel, eps, seed, alpha=0.99,
                             lambda_reg=1e-5, scale_grad=1.0,
                             prior_scale=0.0, batch_size=20, n_data=100,
                             state_dtype=torch.float32, n_inputs=1, h=50,
                             noise_impl="box_muller", step=0, noise=None):
    """Plain PyTorch version of :func:`fused_bnn_step_psgld`."""
    layout, eps_vec = _validate(
        "fused_bnn_step_psgld", theta, {"v": (v, (state_dtype,))},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, False,
        noise_impl, noise, None, n_inputs)
    theta, v, _, cost = _rule_steps(
        "psgld", theta, v, None, layout, 1,
        _gathered_inputs(seed, step, layout, x_sel, y_sel, noise, theta,
                         noise_impl),
        _psgld_table(eps_vec), _psgld_constants(alpha, lambda_reg,
                                                scale_grad),
        prior_scale, batch_size, n_data, state_dtype)
    return theta, v, cost


def fused_bnn_step_sgnht_ref(theta, v, xi, x_sel, y_sel, eps, seed,
                             a_diff=1.0, scale_grad=1.0, prior_scale=0.0,
                             batch_size=20, n_data=100,
                             state_dtype=torch.float32, n_inputs=1, h=50,
                             noise_impl="box_muller", step=0, noise=None):
    """Plain PyTorch version of :func:`fused_bnn_step_sgnht`."""
    layout, eps_vec = _validate(
        "fused_bnn_step_sgnht", theta, {"v": (v, (state_dtype,))},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, False,
        noise_impl, noise, None, n_inputs, xi=xi)
    return _rule_steps(
        "sgnht", theta, v, xi, layout, 1,
        _gathered_inputs(seed, step, layout, x_sel, y_sel, noise, theta,
                         noise_impl),
        _sgnht_table(eps_vec, a_diff, scale_grad), _sgnht_constants(layout),
        prior_scale, batch_size, n_data, state_dtype)


def fused_bnn_step_rsghmc_ref(theta, v, x_sel, y_sel, eps, seed, mass=1.0,
                              speed_of_light=1.0, d_coef=1.0, b_hat=0.0,
                              prior_scale=0.0, batch_size=20, n_data=100,
                              state_dtype=torch.float32, n_inputs=1, h=50,
                              noise_impl="box_muller", step=0, noise=None):
    """Plain PyTorch version of :func:`fused_bnn_step_rsghmc`."""
    layout, eps_vec = _validate(
        "fused_bnn_step_rsghmc", theta, {"v": (v, (state_dtype,))},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, False,
        noise_impl, noise, None, n_inputs)
    theta, v, _, cost = _rule_steps(
        "rsghmc", theta, v, None, layout, 1,
        _gathered_inputs(seed, step, layout, x_sel, y_sel, noise, theta,
                         noise_impl),
        _rsghmc_table(eps_vec, d_coef, b_hat),
        _rsghmc_constants(mass, speed_of_light, d_coef), prior_scale,
        batch_size, n_data, state_dtype)
    return theta, v, cost


def fused_bnn_multistep_psgld_ref(theta, v, x_win, y_win, eps, seed,
                                  alpha=0.99, lambda_reg=1e-5,
                                  scale_grad=1.0, prior_scale=0.0,
                                  batch_size=20, n_data=100, k_steps=1, h=50,
                                  pair_dots=False, noise_impl="box_muller",
                                  step0=0, noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep_psgld`."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep_psgld", theta, {"v": (v, F32)},
        x_win, y_win, eps, seed, batch_size, torch.float32, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    theta, v, _, cost = _rule_steps(
        "psgld", theta, v, None, layout, k_steps,
        _window_inputs(seed, step0, layout, x_win, y_win, noise, widx, theta,
                       noise_impl),
        _psgld_table(eps_vec), _psgld_constants(alpha, lambda_reg,
                                                scale_grad),
        prior_scale, batch_size, n_data, pair_dots=pair_dots)
    return theta, v, cost


def fused_bnn_multistep_sgnht_ref(theta, v, xi, x_win, y_win, eps, seed,
                                  a_diff=1.0, scale_grad=1.0,
                                  prior_scale=0.0, batch_size=20,
                                  n_data=100, state_dtype=torch.float32,
                                  k_steps=1, h=50, pair_dots=False,
                                  noise_impl="box_muller", step0=0,
                                  noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep_sgnht`."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep_sgnht", theta, {"v": (v, (state_dtype,))},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx, xi=xi)
    return _rule_steps(
        "sgnht", theta, v, xi, layout, k_steps,
        _window_inputs(seed, step0, layout, x_win, y_win, noise, widx, theta,
                       noise_impl),
        _sgnht_table(eps_vec, a_diff, scale_grad), _sgnht_constants(layout),
        prior_scale, batch_size, n_data, state_dtype, pair_dots)


def fused_bnn_multistep_rsghmc_ref(theta, v, x_win, y_win, eps, seed,
                                   mass=1.0, speed_of_light=1.0, d_coef=1.0,
                                   b_hat=0.0, prior_scale=0.0, batch_size=20,
                                   n_data=100, state_dtype=torch.float32,
                                   k_steps=1, h=50, pair_dots=False,
                                   noise_impl="box_muller", step0=0,
                                   noise=None, widx=None):
    """Plain PyTorch version of :func:`fused_bnn_multistep_rsghmc`."""
    layout, eps_vec = _validate(
        "fused_bnn_multistep_rsghmc", theta, {"v": (v, (state_dtype,))},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    theta, v, _, cost = _rule_steps(
        "rsghmc", theta, v, None, layout, k_steps,
        _window_inputs(seed, step0, layout, x_win, y_win, noise, widx, theta,
                       noise_impl),
        _rsghmc_table(eps_vec, d_coef, b_hat),
        _rsghmc_constants(mass, speed_of_light, d_coef), prior_scale,
        batch_size, n_data, state_dtype, pair_dots)
    return theta, v, cost


def _one_step_noise(theta, layout, seed, step, noise, noise_impl):
    if noise is not None:
        return noise
    return _step_normals(noise_impl, seed, step, theta.shape[0], layout,
                        theta.device)


def _check_selection(name, noise, pair_dots):
    """``select_in_kernel`` (B1 at one step) refuses injected noise and,
    as JAX's, ``pair_dots``."""
    if noise is not None:
        raise ValueError(
            "{}: select_in_kernel does not combine with injected noise".format(
                name))
    if pair_dots:
        raise ValueError(
            "pair_dots does not combine with noise injection or "
            "select_in_kernel")


def _check_pair_dots(layout, n_chains, noise_impl, one_step, noise):
    """JAX's refusals of ``pair_dots`` (its ``_check_pair_dots`` and
    ``fused_bnn_step``'s), in its order: the 64-slot layout only (``h <=
    50``); the one-step kernel without injected noise; an even number of
    chains (JAX's even ``block_chains``); the one-step kernel with one
    input; depth 3; Box-Muller."""
    if clt_slot(layout.hidden)[0] != 64:
        raise ValueError("pair_dots supports the 64-slot layout only")
    if one_step and noise is not None:
        raise ValueError(
            "pair_dots does not combine with noise injection or "
            "select_in_kernel")
    if n_chains % 2:
        raise ValueError(
            "pair_dots requires an even number of chains (JAX: an even "
            "block_chains); got {}".format(n_chains))
    if one_step and layout.n_inputs != 1:
        raise ValueError("pair_dots supports n_inputs=1 only")
    if layout.depth != 3:
        raise ValueError(
            "pair_dots supports the flagship 3-hidden-layer topology only "
            "(got {} hidden layers); use pair_dots=False for other "
            "depths".format(layout.depth))
    if noise_impl != "box_muller":
        raise ValueError(
            "pair_dots kernels support noise_impl='box_muller' only")


#  Validation and per-step tables, shared by the kernels and their plain versions

def _check_xi(name, theta, xi):
    """SGNHT's thermostat must be float32 ``(n_chains,)`` on theta's
    device."""
    if (not torch.is_tensor(xi) or xi.shape != theta.shape[:1]
            or xi.dtype != torch.float32 or xi.device != theta.device):
        raise ValueError(
            "{}: xi must be a float32 ({},) per-chain tensor on {}".format(
                name, theta.shape[0], theta.device))


def _validate(name, theta, state, x, y, eps, seed, batch_size, state_dtype,
              k_steps, h, pair_dots, noise_impl, noise, widx, n_inputs=None,
              xi=None):
    """Check every operand; returns ``(layout, eps (k_steps,))``.

    ``x``/``y`` are the shared window tables of :func:`data_windows`; with
    ``n_inputs`` given (the one-step kernels) they are instead each chain's
    gathered minibatch (:func:`gather_batch`), ``(n_chains, batch)`` or
    ``(n_chains, batch, n_inputs)``, and ``noise`` is ``(n_chains, P)``.
    ``xi`` is SGNHT's thermostat, where the rule has one.  ``state`` maps
    each state operand's name to ``(tensor, the dtypes it may have)``:
    float32 (``F32``), ``state_dtype`` (the momentum or accumulator), or
    float32 or bfloat16 (``STATE_DTYPES``, a frozen minv).
    """
    _seed_key(seed)
    if noise_impl not in NOISE_IMPLS:
        raise ValueError(
            "{}: noise_impl must be 'box_muller' or 'hadamard_clt'; got "
            "{!r}".format(name, noise_impl))
    if noise is not None and noise_impl != "box_muller":
        raise ValueError(
            "noise_impl selects the in-kernel PRNG generator; it does not "
            "combine with injected noise arrays")
    if state_dtype not in STATE_DTYPES:
        raise ValueError(
            "{}: state_dtype must be torch.float32 or torch.bfloat16; got "
            "{}".format(name, state_dtype))
    if int(k_steps) < 1:
        raise ValueError("{}: k_steps must be >= 1; got {}".format(
            name, k_steps))
    device = theta.device
    if theta.ndim != 2 or theta.dtype != torch.float32:
        raise ValueError(
            "{}: theta must be a float32 (n_chains, P) tensor; got {} "
            "{}".format(name, theta.dtype, tuple(theta.shape)))
    for label, (arr, dtypes) in state.items():
        if (arr.shape != theta.shape or arr.dtype not in dtypes
                or arr.device != device):
            raise ValueError(
                "{}: every state tensor must match theta ({} {} on {}); "
                "got {} {} {} on {}".format(
                    name, tuple(theta.shape), " or ".join(
                        str(d) for d in dtypes), device, label,
                    tuple(arr.shape), arr.dtype, arr.device))
    if xi is not None:
        _check_xi(name, theta, xi)
    n = theta.shape[0]
    gathered = n_inputs is not None
    if gathered:
        want_ndim = 2 if n_inputs == 1 else 3
        if (x.ndim != want_ndim or y.ndim != 2 or x.shape[:2] != y.shape
                or x.shape[0] != n
                or (want_ndim == 3 and x.shape[2] != n_inputs)):
            raise ValueError(
                "{}: x_sel must be (n_chains, batch) for one input or "
                "(n_chains, batch, n_inputs) and y_sel (n_chains, batch) "
                "from gather_batch, with n_chains = {} and n_inputs = {}; "
                "got {} and {}".format(name, n, n_inputs, tuple(x.shape),
                                       tuple(y.shape)))
    elif x.ndim not in (2, 3) or y.ndim != 2 or x.shape[:2] != y.shape:
        raise ValueError(
            "{}: x_win must be (n_windows, batch) or (n_windows, batch, "
            "n_inputs) and y_win (n_windows, batch) from data_windows; got "
            "{} and {}".format(name, tuple(x.shape), tuple(y.shape)))
    for arr in (x, y):
        if arr.dtype != torch.float32 or arr.device != device:
            raise ValueError(
                "{}: minibatch tables must be float32 on {}".format(
                    name, device))
    if x.shape[1] != batch_size:
        raise ValueError(
            "{}: batch_size {} does not match the minibatch's {} rows".format(
                name, batch_size, x.shape[1]))
    layout = layout_for(theta.shape[1], 1 if x.ndim == 2 else x.shape[2],
                        int(h))
    if pair_dots:
        _check_pair_dots(layout, n, noise_impl, gathered, noise)
    k_steps = int(k_steps)
    noise_shape = ((n, layout.n_params) if gathered
                   else (k_steps, n, layout.n_params))
    if noise is not None and (noise.shape != noise_shape
                              or noise.dtype != torch.float32
                              or noise.device != device):
        raise ValueError("{}: noise must be float32 {} on {}".format(
            name, noise_shape, device))
    if widx is not None:
        if (widx.shape != (k_steps, n) or widx.dtype != torch.int32
                or widx.device != device):
            raise ValueError(
                "{}: widx must be int32 ({}, {}) on {}".format(
                    name, k_steps, n, device))
        if widx.numel() and (int(widx.min()) < 0
                             or int(widx.max()) >= x.shape[0]):
            raise ValueError("{}: widx out of [0, {})".format(
                name, x.shape[0]))
    eps_vec = torch.as_tensor(eps, dtype=torch.float32).reshape(-1)
    if eps_vec.numel() not in (1, k_steps):
        raise ValueError(
            "{}: eps must be a scalar or a (k_steps,) vector".format(name))
    # non_blocking: a pageable source is staged before the call returns, and
    # the launch does not wait for the stream to drain
    return layout, eps_vec.to(device, non_blocking=True).expand(k_steps)


def _sghmc_table(eps_vec, scale_grad):
    """SGHMC per-step table ``(k, 2)``: eps, eps / sqrt(scale_grad)."""
    # filled on the device: torch.tensor(..., device=) would copy from the
    # host and wait for the stream
    eps_scaled = eps_vec / torch.sqrt(torch.full(
        (), scale_grad, dtype=torch.float32, device=eps_vec.device))
    return torch.stack([eps_vec, eps_scaled], dim=1).contiguous()


def _sgld_constants(a_coef, scale_grad, burnin):
    """SGLD's ``(A, c)`` rounded to float32: ``c`` is the host-computed ``A
    / scale_grad`` in sampling, as JAX's ``fused_bnn_multistep_sgld``
    computes it, and ``sg_safe = sg + 2 sign(sg) 1e-16 + 1e-16`` in float32
    in burn-in, as JAX's B6 driver does."""
    if burnin:
        sg = torch.tensor(scale_grad, dtype=torch.float32)
        c = sg + 2.0 * torch.sign(sg) * 1e-16 + 1e-16
    else:
        c = a_coef / scale_grad
    return _f32(a_coef), float(torch.as_tensor(c, dtype=torch.float32))


def _f32(x):
    """``x`` rounded to float32, as a Python float (a kernel's scalar)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _psgld_table(eps_vec):
    """pSGLD per-step table ``(k, 1)``: eps."""
    return eps_vec[:, None].contiguous()


def _sgnht_table(eps_vec, a_diff, scale_grad):
    """SGNHT per-step table ``(k, 2)``: eps, sqrt(max(2 A eps /
    scale_grad, 0)) (JAX ``fused_bnn_multistep_sgnht``)."""
    sigma = torch.sqrt(torch.clamp(2.0 * a_diff * eps_vec / scale_grad,
                                   min=0.0))
    return torch.stack([eps_vec, sigma], dim=1).contiguous()


def _rsghmc_table(eps_vec, d_coef, b_hat):
    """Relativistic SGHMC per-step table ``(k, 2)``: eps, sqrt(max(eps (2 D
    - eps Bhat), 0)) (JAX ``fused_bnn_multistep_rsghmc``)."""
    noise_scale = torch.sqrt(torch.clamp(
        eps_vec * (2.0 * d_coef - eps_vec * b_hat), min=0.0))
    return torch.stack([eps_vec, noise_scale], dim=1).contiguous()


def _psgld_constants(alpha, lambda_reg, scale_grad):
    """pSGLD's kernel constants in float32: ``coef`` alpha, ``cdiv``
    lambda, ``c2`` 1 / scale_grad."""
    return dict(coef=_f32(alpha), cdiv=_f32(lambda_reg),
                c2=_f32(1.0 / scale_grad))


def _sgnht_constants(layout):
    """SGNHT's kernel constant in float32: ``c2`` 1 / P, P the real
    parameter count (JAX's ``n_dim``)."""
    return dict(c2=_f32(1.0 / layout.n_params))


def _rsghmc_constants(mass, speed_of_light, d_coef):
    """Relativistic SGHMC's kernel constants in float32: ``coef`` D, ``c2``
    1 / m, ``c3`` 1 / (m^2 c^2)."""
    return dict(coef=_f32(d_coef), c2=_f32(1.0 / mass),
                c3=_f32(1.0 / (mass * mass * speed_of_light
                               * speed_of_light)))


def gather_batch(x_win, y_win, widx):
    """Each chain's minibatch rows: ``(x_win[widx], y_win[widx])``.

    The windows of JAX's ``gather_batch``, without the TPU kernel's padding
    to 24 rows and its ones lane: ``x_sel`` is ``(n_chains, batch)`` for
    one input feature and ``(n_chains, batch, n_inputs)`` otherwise,
    ``y_sel`` ``(n_chains, batch)``.
    """
    widx = torch.as_tensor(widx, device=x_win.device).to(torch.int64)
    return x_win[widx].contiguous(), y_win[widx].contiguous()


#  Kernel wrappers ----------------------------------------------------------------

# kernel ids of csrc/fused_step.cu (its KernelId enum)
B1, B2, B3, B4_SGLD, B5_SGLD, B6 = 1, 2, 3, 4, 5, 6
B4_PSGLD, B4_SGNHT, B4_RSGHMC, B5_PSGLD, B5_SGNHT, B5_RSGHMC = range(7, 13)


def fused_placement(kernel_id, layout, batch_size):
    """Where a launch of fused kernel ``kernel_id`` keeps each chain's P-long
    arrays: ``"shared"`` where one chain's state and scratch fit a block's
    shared memory by the library's own count (``fused_step_smem_bytes`` of
    ``csrc/fused_step.cu``, at most ``MAX_SMEM_BYTES``), else ``"device"``
    (a workspace in device memory; the scratch stays in shared memory).
    The count alone decides.  Builds the library if needed."""
    from pysgmcmc_tpu_torch.ops._build import MAX_SMEM_BYTES, load

    need = load("fused_step").fused_step_smem_bytes(
        kernel_id, layout.n_params, layout.n_inputs, layout.hidden,
        layout.depth, batch_size)
    return "shared" if need <= MAX_SMEM_BYTES else "device"


# launches of each fused kernel by placement: (C entry name without
# "_launch", placement) -> count; callers may clear it
placements = collections.Counter()

# the library (csrc/<name>.cu) and C entry suffix of each variant of the
# fused kernels: the noise generator, or the paired kernels
_VARIANTS = {"box_muller": ("fused_step", ""),
             "hadamard_clt": ("fused_step_clt", "_clt"),
             "paired": ("fused_step_paired", "_paired")}


def _variant(noise_impl, pair_dots=False):
    return "paired" if pair_dots else noise_impl


def variant_launches(wrapper, variant="box_muller"):
    """The launches of the fused ``wrapper``'s ``variant``
    (:data:`_VARIANTS`: ``"box_muller"``, ``"hadamard_clt"`` or
    ``"paired"``) since :data:`placements` was cleared, in both
    placements.  (``wrapper.launches`` counts all of its launches.)"""
    entry = wrapper.__name__ + _VARIANTS[variant][1]
    return sum(count for (name, _), count in placements.items()
               if name == entry)


def _ptr(t):
    return None if t is None else t.data_ptr()


# the state operands of every launch entry, in its argument order; a kernel
# passes NULL for those its rule and phase do not have
_STATE_IN = ("theta", "v", "minv", "tau", "g", "v_hat", "xi")
_STATE_OUT = ("theta", "v", "tau", "g", "v_hat", "minv", "xi")


def _is_bf16(t):
    return int(t is not None and t.dtype == torch.bfloat16)


def _launch(name, kernel_id, layout, ins, outs, x, y, tab, noise, widx,
            k_steps, seed, step0, prior_scale, batch_size, n_data, coef=0.0,
            cdiv=0.0, c2=0.0, c3=0.0, variant="box_muller"):
    """Launch kernel ``kernel_id`` through the C entry ``name + suffix +
    "_launch"`` of the library of ``variant`` (:data:`_VARIANTS`:
    ``csrc/fused_step.cu``, ``fused_step_clt.cu`` or
    ``fused_step_paired.cu``).

    ``ins`` maps state names (``_STATE_IN``) to ``(n_chains, P)`` tensors
    (SGNHT's ``xi`` ``(n_chains,)``; ``v`` and ``minv`` float32 or
    bfloat16), ``outs`` names the state outputs to allocate; ``tab`` is the
    per-step table (SGHMC ``(k, 2)``: eps, eps / sqrt(scale_grad); SGLD
    ``(k,)`` and pSGLD ``(k, 1)``: eps; SGNHT and relativistic SGHMC ``(k,
    2)``: eps and the noise scale), ``coef``, ``cdiv``, ``c2`` and ``c3``
    the rule's constants as the source's ``Args`` lists them (``mdecay``
    for SGHMC, :func:`_sgld_constants`, :func:`_psgld_constants`, ...).
    Checks contiguity, places the state by :func:`fused_placement` (a
    device-memory workspace where it does not fit shared memory), counts
    the launch in :data:`placements`, raises on a failed launch, and
    returns the outputs in ``outs`` order, then the ``(n_chains, 1)``
    cost.  The paired kernels keep their state in shared memory only.
    """
    from pysgmcmc_tpu_torch.ops import _build

    theta = ins["theta"]
    for arr in (*ins.values(), x, y, tab, noise, widx):
        if arr is not None and not arr.is_contiguous():
            raise ValueError("{}: CUDA operands must be contiguous".format(name))
    source, suffix = _VARIANTS[variant]
    lib = _build.load(source)
    n = theta.shape[0]
    placement = fused_placement(kernel_id, layout, batch_size)
    work = None
    if placement == "device":
        if variant == "paired":
            raise ValueError("{}: the paired kernels keep their state in "
                             "shared memory, and it does not fit".format(name))
        work = torch.empty(
            (n, _build.load("fused_step").fused_step_workspace_floats(
                kernel_id, layout.n_params)),
            dtype=torch.float32, device=theta.device)
    # each output shaped as its input, in its type (burn-in's minv as theta)
    out = {key: torch.empty_like(ins.get(key, theta)) for key in outs}
    cost = torch.empty((n, 1), dtype=torch.float32, device=theta.device)
    entry = name + suffix
    with torch.cuda.device(theta.device):  # the launch uses the current device
        _build.check(getattr(lib, entry + "_launch")(
            *[_ptr(ins.get(key)) for key in _STATE_IN], _ptr(x), _ptr(y),
            _ptr(tab), _ptr(noise), _ptr(widx),
            *[_ptr(out.get(key)) for key in _STATE_OUT], _ptr(cost),
            n, layout.n_inputs, layout.hidden, layout.depth, batch_size,
            x.shape[0], int(k_steps), layout.n_params, int(seed),
            int(step0) & _MASK32, float(coef), float(cdiv), float(c2),
            float(c3), float(prior_scale), 1.0 / batch_size, 1.0 / n_data,
            _is_bf16(ins.get("v")), _is_bf16(ins.get("minv")), _ptr(work),
            torch.cuda.current_stream().cuda_stream), source)
    placements[(entry, placement)] += 1
    return (*[out[key] for key in outs], cost)


def _require_device(name, theta):
    if theta.device.type not in ("cpu", "cuda"):
        raise ValueError("{}: tensors must be on the CPU or a CUDA device; "
                         "got {}".format(name, theta.device))
    return theta.device.type == "cuda"


def fused_bnn_multistep(theta, v, minv, x_win, y_win, eps, seed,
                        mdecay=0.05, scale_grad=1.0, prior_scale=0.0,
                        batch_size=20, n_data=100, state_dtype=torch.float32,
                        k_steps=1, h=50, pair_dots=False,
                        noise_impl="box_muller", step0=0, noise=None,
                        widx=None):
    """``k_steps`` fused SGHMC sampling steps with a frozen ``minv`` (B1).

    ``theta``/``v``/``minv`` are ``(n_chains, P)`` in the
    :class:`FusedLayout` of a ``h``-wide network, ``theta`` float32, ``v``
    in ``state_dtype`` (float32 or bfloat16; ``v'`` keeps it) and ``minv``
    float32 or bfloat16; ``x_win``/``y_win`` the
    shared window tables of :func:`data_windows`; ``eps`` a scalar or a
    ``(k_steps,)`` vector of per-step stepsizes; ``seed`` the 64-bit Philox
    key and ``step0`` the absolute step of the first step.  Returns
    ``(theta', v', cost)`` with ``cost`` ``(n_chains, 1)``, the final
    step's.  ``noise_impl`` picks the normals' generator (``"box_muller"``
    or ``"hadamard_clt"``, each its own instantiation); ``pair_dots=True``
    launches the paired instantiation (module docstring).
    ``fused_bnn_multistep.launches`` counts every launch,
    :func:`variant_launches` each variant's.  CUDA
    tensors launch the kernel; CPU tensors run
    :func:`fused_bnn_multistep_ref`.
    """
    name = "fused_bnn_multistep"
    if not _require_device(name, theta):
        return fused_bnn_multistep_ref(
            theta, v, minv, x_win, y_win, eps, seed, mdecay, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, k_steps, h,
            pair_dots, noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,)), "minv": (minv, STATE_DTYPES)},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B1, layout, dict(theta=theta, v=v, minv=minv),
                  ("theta", "v"), x_win, y_win,
                  _sghmc_table(eps_vec, scale_grad), noise, widx, k_steps,
                  seed, step0, prior_scale, batch_size, n_data, coef=mdecay,
                  variant=variant)
    fused_bnn_multistep.launches += 1
    return out


fused_bnn_multistep.launches = 0


def fused_bnn_multistep_burnin(theta, v, tau, g, v_hat, x_win, y_win, eps,
                               seed, mdecay=0.05, scale_grad=1.0,
                               prior_scale=0.0, batch_size=20, n_data=100,
                               state_dtype=torch.float32, k_steps=1, h=50,
                               pair_dots=False, noise_impl="box_muller",
                               step0=0, noise=None, widx=None):
    """``k_steps`` fused SGHMC burn-in steps (B2): the Springenberg et al.
    tau/g/v_hat EMAs with ``minv = 1/sqrt(old v_hat)``, all reading old
    values.  Arguments as :func:`fused_bnn_multistep`.  Returns
    ``(theta', v', tau', g', v_hat', minv, cost)`` where ``minv`` is the
    mass-matrix inverse the final step used (the value the sampling phase
    freezes)."""
    name = "fused_bnn_multistep_burnin"
    if not _require_device(name, theta):
        return fused_bnn_multistep_burnin_ref(
            theta, v, tau, g, v_hat, x_win, y_win, eps, seed, mdecay,
            scale_grad, prior_scale, batch_size, n_data, state_dtype,
            k_steps, h, pair_dots, noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta,
        {"v": (v, (state_dtype,)), "tau": (tau, F32), "g": (g, F32),
         "v_hat": (v_hat, F32)},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B2, layout,
                  dict(theta=theta, v=v, tau=tau, g=g, v_hat=v_hat),
                  ("theta", "v", "tau", "g", "v_hat", "minv"), x_win, y_win,
                  _sghmc_table(eps_vec, scale_grad), noise, widx, k_steps,
                  seed, step0, prior_scale, batch_size, n_data, coef=mdecay,
                  variant=variant)
    fused_bnn_multistep_burnin.launches += 1
    return out


fused_bnn_multistep_burnin.launches = 0


def fused_bnn_step(theta, v, minv, x_sel, y_sel, eps, seed, mdecay=0.05,
                   scale_grad=1.0, prior_scale=0.0, batch_size=20,
                   n_data=100, state_dtype=torch.float32,
                   select_in_kernel=False, pair_dots=False, n_inputs=1,
                   h=50, noise_impl="box_muller", step=0, noise=None):
    """One fused SGHMC step on each chain's gathered minibatch (B3).

    ``x_sel``/``y_sel`` are the rows :func:`gather_batch` picked for each
    chain; ``noise`` is ``(n_chains, P)`` injected normals, or ``None`` for
    the Philox stream at absolute ``step`` (the counters of
    :func:`fused_bnn_multistep`, so k launches of this kernel on the
    windows :func:`philox_windows` draws follow one B1 launch of k steps).
    Other arguments as :func:`fused_bnn_multistep`; returns ``(theta', v',
    cost)``.  ``select_in_kernel=True`` takes the shared window tables
    instead and is B1 at ``k_steps=1``: it calls :func:`fused_bnn_multistep`
    and counts as a B1 launch.  ``pair_dots=True`` launches B3 paired
    (JAX's ``_make_kernel_paired``), which at one step is B3's arithmetic
    and rounding; like JAX's it draws its own noise and takes one input.
    CPU tensors run :func:`fused_bnn_step_ref`.
    """
    name = "fused_bnn_step"
    if select_in_kernel:
        _check_selection(name, noise, pair_dots)
        return fused_bnn_multistep(
            theta, v, minv, x_sel, y_sel, eps, seed, mdecay, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, 1, h, pair_dots,
            noise_impl, step)
    if not _require_device(name, theta):
        return fused_bnn_step_ref(
            theta, v, minv, x_sel, y_sel, eps, seed, mdecay, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, False, pair_dots,
            n_inputs, h, noise_impl, step, noise)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,)), "minv": (minv, STATE_DTYPES)},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, pair_dots,
        noise_impl, noise, None, n_inputs)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B3, layout, dict(theta=theta, v=v, minv=minv),
                  ("theta", "v"), x_sel, y_sel,
                  _sghmc_table(eps_vec, scale_grad), noise, None, 1, seed,
                  step, prior_scale, batch_size, n_data, coef=mdecay,
                  variant=variant)
    fused_bnn_step.launches += 1
    return out


fused_bnn_step.launches = 0


def fused_bnn_step_sgld(theta, minv, x_sel, y_sel, eps, seed, a_coef=1.0,
                        scale_grad=1.0, prior_scale=0.0, batch_size=20,
                        n_data=100, n_inputs=1, h=50,
                        noise_impl="box_muller", step=0, noise=None):
    """One fused SGLD step on each chain's gathered minibatch (B4-sgld):
    ``theta += where(minv > 0, -eps minv A g + sqrt(2 eps minv A /
    scale_grad) eta, 0)`` with ``g`` the gradient plus ``prior_scale *
    theta``.  Arguments as :func:`fused_bnn_step`, with ``a_coef`` (the
    sampler's ``A``) for ``mdecay`` and no momentum; returns ``(theta',
    cost)``.  CPU tensors run :func:`fused_bnn_step_sgld_ref`."""
    name = "fused_bnn_step_sgld"
    if not _require_device(name, theta):
        return fused_bnn_step_sgld_ref(
            theta, minv, x_sel, y_sel, eps, seed, a_coef, scale_grad,
            prior_scale, batch_size, n_data, n_inputs, h, noise_impl, step,
            noise)
    layout, eps_vec = _validate(
        name, theta, {"minv": (minv, STATE_DTYPES)},
        x_sel, y_sel, eps, seed, batch_size, torch.float32, 1, h, False,
        noise_impl, noise, None, n_inputs)
    a_coef, c = _sgld_constants(a_coef, scale_grad, False)
    variant = _variant(noise_impl)
    out = _launch(name, B4_SGLD, layout, dict(theta=theta, minv=minv),
                  ("theta",), x_sel, y_sel, eps_vec.contiguous(), noise, None,
                  1, seed, step, prior_scale, batch_size, n_data,
                  coef=a_coef, cdiv=c,
                  variant=variant)
    fused_bnn_step_sgld.launches += 1
    return out


fused_bnn_step_sgld.launches = 0


def fused_bnn_multistep_sgld(theta, minv, x_win, y_win, eps, seed,
                             a_coef=1.0, scale_grad=1.0, prior_scale=0.0,
                             batch_size=20, n_data=100, k_steps=1, h=50,
                             pair_dots=False, noise_impl="box_muller",
                             step0=0, noise=None, widx=None):
    """``k_steps`` fused SGLD sampling steps with a frozen ``minv``
    (B5-sgld).  The update is :func:`fused_bnn_step_sgld`'s, the windows
    and noise :func:`fused_bnn_multistep`'s.  Returns ``(theta', cost)``.
    CPU tensors run :func:`fused_bnn_multistep_sgld_ref`."""
    name = "fused_bnn_multistep_sgld"
    if not _require_device(name, theta):
        return fused_bnn_multistep_sgld_ref(
            theta, minv, x_win, y_win, eps, seed, a_coef, scale_grad,
            prior_scale, batch_size, n_data, k_steps, h, pair_dots,
            noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta, {"minv": (minv, STATE_DTYPES)},
        x_win, y_win, eps, seed, batch_size, torch.float32, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    a_coef, c = _sgld_constants(a_coef, scale_grad, False)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B5_SGLD, layout, dict(theta=theta, minv=minv),
                  ("theta",), x_win, y_win, eps_vec.contiguous(), noise, widx,
                  k_steps, seed, step0, prior_scale, batch_size, n_data,
                  coef=a_coef, cdiv=c,
                  variant=variant)
    fused_bnn_multistep_sgld.launches += 1
    return out


fused_bnn_multistep_sgld.launches = 0


def fused_bnn_multistep_burnin_sgld(theta, tau, g, v_hat, x_win, y_win, eps,
                                    seed, a_coef=1.0, scale_grad=1.0,
                                    prior_scale=0.0, batch_size=20,
                                    n_data=100, k_steps=1, h=50,
                                    pair_dots=False, noise_impl="box_muller",
                                    step0=0, noise=None, widx=None):
    """``k_steps`` fused SGLD burn-in steps (B6): the EMAs of
    :func:`fused_bnn_multistep_burnin` and the update ``theta += -eps minv
    A g + sqrt(max(2 eps (minv A) / sg_safe, 0)) eta`` with ``sg_safe =
    scale_grad + 2 sign(scale_grad) 1e-16 + 1e-16``.  Returns ``(theta',
    tau', g', v_hat', minv, cost)``, ``minv`` the value the final step used.
    CPU tensors run :func:`fused_bnn_multistep_burnin_sgld_ref`."""
    name = "fused_bnn_multistep_burnin_sgld"
    if not _require_device(name, theta):
        return fused_bnn_multistep_burnin_sgld_ref(
            theta, tau, g, v_hat, x_win, y_win, eps, seed, a_coef,
            scale_grad, prior_scale, batch_size, n_data, k_steps, h,
            pair_dots, noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta, {"tau": (tau, F32), "g": (g, F32), "v_hat": (v_hat, F32)},
        x_win, y_win, eps, seed, batch_size, torch.float32, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    a_coef, c = _sgld_constants(a_coef, scale_grad, True)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B6, layout,
                  dict(theta=theta, tau=tau, g=g, v_hat=v_hat),
                  ("theta", "tau", "g", "v_hat", "minv"), x_win, y_win,
                  eps_vec.contiguous(), noise, widx, k_steps, seed, step0,
                  prior_scale, batch_size, n_data, coef=a_coef, cdiv=c,
                  variant=variant)
    fused_bnn_multistep_burnin_sgld.launches += 1
    return out


fused_bnn_multistep_burnin_sgld.launches = 0


def fused_bnn_step_psgld(theta, v, x_sel, y_sel, eps, seed, alpha=0.99,
                         lambda_reg=1e-5, scale_grad=1.0, prior_scale=0.0,
                         batch_size=20, n_data=100,
                         state_dtype=torch.float32, n_inputs=1, h=50,
                         noise_impl="box_muller", step=0, noise=None):
    """One fused pSGLD step on each chain's gathered minibatch (B4-psgld):
    with ``g`` the gradient plus ``prior_scale * theta``, ``v' = alpha v +
    (1 - alpha) g^2``, ``G = 1 / (lambda_reg + sqrt(max(v', 0)))`` and
    ``theta' = theta - eps/2 G g + sqrt(max(eps G / scale_grad, 0)) eta``.
    ``v`` is the RMSprop accumulator in ``state_dtype``, rounded to it after
    the update as the momenta are; other arguments as
    :func:`fused_bnn_step`.  Returns ``(theta', v', cost)``.  CPU tensors
    run :func:`fused_bnn_step_psgld_ref`."""
    name = "fused_bnn_step_psgld"
    if not _require_device(name, theta):
        return fused_bnn_step_psgld_ref(
            theta, v, x_sel, y_sel, eps, seed, alpha, lambda_reg, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, n_inputs, h,
            noise_impl, step, noise)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,))},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, False,
        noise_impl, noise, None, n_inputs)
    variant = _variant(noise_impl)
    out = _launch(name, B4_PSGLD, layout, dict(theta=theta, v=v),
                  ("theta", "v"), x_sel, y_sel, _psgld_table(eps_vec), noise,
                  None, 1, seed, step, prior_scale, batch_size, n_data,
                  **_psgld_constants(alpha, lambda_reg, scale_grad),
                  variant=variant)
    fused_bnn_step_psgld.launches += 1
    return out


fused_bnn_step_psgld.launches = 0


def fused_bnn_step_sgnht(theta, v, xi, x_sel, y_sel, eps, seed, a_diff=1.0,
                         scale_grad=1.0, prior_scale=0.0, batch_size=20,
                         n_data=100, state_dtype=torch.float32, n_inputs=1,
                         h=50, noise_impl="box_muller", step=0, noise=None):
    """One fused SGNHT step on each chain's gathered minibatch (B4-sgnht):
    ``p' = p - xi eps p - eps g + sqrt(max(2 A eps / scale_grad, 0)) eta``,
    ``theta' = theta + eps p'``, then each chain's thermostat ``xi' = xi +
    eps (p'^T p' / P - 1)``.  ``xi`` is float32 ``(n_chains,)`` (JAX's is a
    replicated ``(n_chains, 128)`` row), ``a_diff`` the sampler's ``A``;
    other arguments as :func:`fused_bnn_step`.  Returns ``(theta', p', xi',
    cost)``.  CPU tensors run :func:`fused_bnn_step_sgnht_ref`."""
    name = "fused_bnn_step_sgnht"
    if not _require_device(name, theta):
        return fused_bnn_step_sgnht_ref(
            theta, v, xi, x_sel, y_sel, eps, seed, a_diff, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, n_inputs, h,
            noise_impl, step, noise)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,))},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, False,
        noise_impl, noise, None, n_inputs, xi=xi)
    variant = _variant(noise_impl)
    out = _launch(name, B4_SGNHT, layout, dict(theta=theta, v=v, xi=xi),
                  ("theta", "v", "xi"), x_sel, y_sel,
                  _sgnht_table(eps_vec, a_diff, scale_grad), noise, None, 1,
                  seed, step, prior_scale, batch_size, n_data,
                  **_sgnht_constants(layout),
                  variant=variant)
    fused_bnn_step_sgnht.launches += 1
    return out


fused_bnn_step_sgnht.launches = 0


def fused_bnn_step_rsghmc(theta, v, x_sel, y_sel, eps, seed, mass=1.0,
                          speed_of_light=1.0, d_coef=1.0, b_hat=0.0,
                          prior_scale=0.0, batch_size=20, n_data=100,
                          state_dtype=torch.float32, n_inputs=1, h=50,
                          noise_impl="box_muller", step=0, noise=None):
    """One fused relativistic SGHMC step on each chain's gathered minibatch
    (B4-rsghmc): with ``vel(p) = eps p / m / sqrt(p^2 / (m^2 c^2) + 1)``,
    ``p' = p - eps g + sqrt(max(eps (2 D - eps Bhat), 0)) eta - D vel(p)``
    and ``theta' = theta + vel(p')``; ``mass``, ``speed_of_light``,
    ``d_coef`` and ``b_hat`` are the sampler's ``m``, ``c``, ``D`` and
    ``Bhat``, other arguments as :func:`fused_bnn_step`.  Returns
    ``(theta', p', cost)``.  CPU tensors run
    :func:`fused_bnn_step_rsghmc_ref`."""
    name = "fused_bnn_step_rsghmc"
    if not _require_device(name, theta):
        return fused_bnn_step_rsghmc_ref(
            theta, v, x_sel, y_sel, eps, seed, mass, speed_of_light, d_coef,
            b_hat, prior_scale, batch_size, n_data, state_dtype, n_inputs, h,
            noise_impl, step, noise)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,))},
        x_sel, y_sel, eps, seed, batch_size, state_dtype, 1, h, False,
        noise_impl, noise, None, n_inputs)
    variant = _variant(noise_impl)
    out = _launch(name, B4_RSGHMC, layout, dict(theta=theta, v=v),
                  ("theta", "v"), x_sel, y_sel,
                  _rsghmc_table(eps_vec, d_coef, b_hat), noise, None, 1, seed,
                  step, prior_scale, batch_size, n_data,
                  **_rsghmc_constants(mass, speed_of_light, d_coef),
                  variant=variant)
    fused_bnn_step_rsghmc.launches += 1
    return out


fused_bnn_step_rsghmc.launches = 0


def fused_bnn_multistep_psgld(theta, v, x_win, y_win, eps, seed, alpha=0.99,
                              lambda_reg=1e-5, scale_grad=1.0,
                              prior_scale=0.0, batch_size=20, n_data=100,
                              k_steps=1, h=50, pair_dots=False,
                              noise_impl="box_muller", step0=0, noise=None,
                              widx=None):
    """``k_steps`` fused pSGLD steps in one launch (B5-psgld): the update
    of :func:`fused_bnn_step_psgld`, the windows and noise of
    :func:`fused_bnn_multistep`; the accumulator ``v`` stays float32.
    Returns ``(theta', v', cost)``.  CPU tensors run
    :func:`fused_bnn_multistep_psgld_ref`."""
    name = "fused_bnn_multistep_psgld"
    if not _require_device(name, theta):
        return fused_bnn_multistep_psgld_ref(
            theta, v, x_win, y_win, eps, seed, alpha, lambda_reg, scale_grad,
            prior_scale, batch_size, n_data, k_steps, h, pair_dots,
            noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, F32)},
        x_win, y_win, eps, seed, batch_size, torch.float32, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B5_PSGLD, layout, dict(theta=theta, v=v),
                  ("theta", "v"), x_win, y_win, _psgld_table(eps_vec), noise,
                  widx, k_steps, seed, step0, prior_scale, batch_size, n_data,
                  **_psgld_constants(alpha, lambda_reg, scale_grad),
                  variant=variant)
    fused_bnn_multistep_psgld.launches += 1
    return out


fused_bnn_multistep_psgld.launches = 0


def fused_bnn_multistep_sgnht(theta, v, xi, x_win, y_win, eps, seed,
                              a_diff=1.0, scale_grad=1.0, prior_scale=0.0,
                              batch_size=20, n_data=100,
                              state_dtype=torch.float32, k_steps=1, h=50,
                              pair_dots=False, noise_impl="box_muller",
                              step0=0, noise=None, widx=None):
    """``k_steps`` fused SGNHT steps in one launch (B5-sgnht): the update
    and thermostat of :func:`fused_bnn_step_sgnht` after every step, the
    windows and noise of :func:`fused_bnn_multistep`.  Returns ``(theta',
    p', xi', cost)``.  CPU tensors run
    :func:`fused_bnn_multistep_sgnht_ref`."""
    name = "fused_bnn_multistep_sgnht"
    if not _require_device(name, theta):
        return fused_bnn_multistep_sgnht_ref(
            theta, v, xi, x_win, y_win, eps, seed, a_diff, scale_grad,
            prior_scale, batch_size, n_data, state_dtype, k_steps, h,
            pair_dots, noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,))},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx, xi=xi)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B5_SGNHT, layout, dict(theta=theta, v=v, xi=xi),
                  ("theta", "v", "xi"), x_win, y_win,
                  _sgnht_table(eps_vec, a_diff, scale_grad), noise, widx,
                  k_steps, seed, step0, prior_scale, batch_size, n_data,
                  **_sgnht_constants(layout),
                  variant=variant)
    fused_bnn_multistep_sgnht.launches += 1
    return out


fused_bnn_multistep_sgnht.launches = 0


def fused_bnn_multistep_rsghmc(theta, v, x_win, y_win, eps, seed, mass=1.0,
                               speed_of_light=1.0, d_coef=1.0, b_hat=0.0,
                               prior_scale=0.0, batch_size=20, n_data=100,
                               state_dtype=torch.float32, k_steps=1, h=50,
                               pair_dots=False, noise_impl="box_muller",
                               step0=0, noise=None, widx=None):
    """``k_steps`` fused relativistic SGHMC steps in one launch
    (B5-rsghmc): the update of :func:`fused_bnn_step_rsghmc`, the windows
    and noise of :func:`fused_bnn_multistep`.  Returns ``(theta', p',
    cost)``.  CPU tensors run :func:`fused_bnn_multistep_rsghmc_ref`."""
    name = "fused_bnn_multistep_rsghmc"
    if not _require_device(name, theta):
        return fused_bnn_multistep_rsghmc_ref(
            theta, v, x_win, y_win, eps, seed, mass, speed_of_light, d_coef,
            b_hat, prior_scale, batch_size, n_data, state_dtype, k_steps, h,
            pair_dots, noise_impl, step0, noise, widx)
    layout, eps_vec = _validate(
        name, theta, {"v": (v, (state_dtype,))},
        x_win, y_win, eps, seed, batch_size, state_dtype, k_steps, h,
        pair_dots, noise_impl, noise, widx)
    variant = _variant(noise_impl, pair_dots)
    out = _launch(name, B5_RSGHMC, layout, dict(theta=theta, v=v),
                  ("theta", "v"), x_win, y_win,
                  _rsghmc_table(eps_vec, d_coef, b_hat), noise, widx,
                  k_steps, seed, step0, prior_scale, batch_size, n_data,
                  **_rsghmc_constants(mass, speed_of_light, d_coef),
                  variant=variant)
    fused_bnn_multistep_rsghmc.launches += 1
    return out


fused_bnn_multistep_rsghmc.launches = 0
