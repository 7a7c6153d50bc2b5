"""Chain drivers over the port's kernels (PyTorch port of the fused and the
chains-on-lanes drivers of :mod:`pysgmcmc_tpu.parallel.packed`) for the five
gradient samplers.

Fused: :func:`burnin_chain_fused` runs the whole self-tuning burn-in of
every chain as one launch of kernel B2 (SGHMC, :func:`~pysgmcmc_tpu_torch.ops.
fused_step.fused_bnn_multistep_burnin`) or B6 (SGLD, ``fused_bnn_multistep_
burnin_sgld``); pSGLD, SGNHT and relativistic SGHMC have no burn-in
machinery and burn in on discarded steps of :func:`sample_chain_lanes`.
:func:`sample_chain_fused` runs the sampling phase as one launch of B1 /
B5-sgld / B5-psgld / B5-sgnht / B5-rsghmc per collected sample
(``multistep=True``) or as one launch of B3 / B4-sgld / B4-psgld / B4-sgnht
/ B4-rsghmc per step (``multistep=False``), each step's windows drawn on the
device with :func:`~pysgmcmc_tpu_torch.ops.fused_step.philox_windows` and
gathered with ``gather_batch``.  The drivers evaluate
the stepsize schedule at the absolute steps ``step0 + t`` and ship a per-step
table, and draw one 64-bit Philox seed per call from the caller's
``torch.Generator``; the kernels key their streams on (chain, absolute
step), so no re-seeding is needed, and the two sampling granularities give
the same chains from the same seed.  ``pair_dots=True`` runs the paired
kernels (B1, B2, B5-*, B6 paired; multi-step only) in launches of at most
:data:`MAX_STEPS_PER_LAUNCH` steps, where JAX's drivers cut theirs: at bf16
state a paired launch rounds the matrix slabs' momentum once, at its end.

Chains on lanes: :func:`burnin_chain_lanes` and :func:`sample_chain_lanes`
take any network and cost function.  Each step unpacks the ``(n_chains,
P)`` position (:func:`pack_lanes` / :func:`unpack_lanes`), takes every
chain's gradient with ``torch.func.vmap(torch.func.grad_and_value(
sampler.cost_fn))`` (one chain: plain autograd on its leaves, which takes a
network whose shapes follow the data, as a dropless expert layer's do),
packs it, and makes one launch of a slim elementwise
kernel (:mod:`pysgmcmc_tpu_torch.ops.slim_update`): B9-sghmc / B9-sgld in
burn-in, B7 / B8-sgld in sampling, and for pSGLD, relativistic SGHMC and
SGNHT, which have no burn-in machinery, B8-psgld / B8-rsghmc / B8-sgnht in
:func:`sample_chain_lanes` (SGNHT's thermostat follows each launch as one
reduction over every chain's row).  Each chain's minibatch is
``batch_fn(seed, step, n_chains)`` (:func:`pysgmcmc_tpu_torch.data_batches.
batch_fn`), ``batch_fn=None`` a full-data cost.  With the same seed, on the
dense network, windows and noise are those of the fused drivers.  A stacked
per-chain schedule state gives every chain its own stepsize.

Packed and stacked (SGHMC's sampling phase, as JAX's): :func:`sample_chain_packed`
keeps the state as one ``(n_chains, width)`` slab in JAX's public slot
layout (:func:`make_pack_spec`: the leaves in sorted-key order, each in a
128-aligned slot; :func:`pack_tree`, :func:`unpack_tree`,
:func:`pack_mask`), takes the gradient on the unpacked leaves in
``compute_dtype`` and makes one launch of B7 mask per step, whose mask row
keeps the slot padding at 0.  :func:`sample_chain_stacked` keeps every leaf
in its own stacked shape and makes one launch of B7' per step for all
leaves, optionally emitting the bf16 copy of the position that the next
gradient pass reads (``bf16_params``).  Both key each normal by the
element's index in the chain's unpadded row in the position dict's order,
and draw windows and the Philox key as :func:`sample_chain_lanes` does, so
the three drivers give the same chains for the same state and generator.

Precision, as JAX's drivers: the fused drivers keep the momentum (and
SGHMC's and SGLD's frozen minv) in ``state_dtype``, ``torch.bfloat16`` by
default, rounded every step inside the kernels; the lanes drivers run the
network passes in ``compute_dtype``, ``torch.bfloat16`` by default, and
keep their state in ``state_dtype``, ``torch.float32`` by default.  States
come back float32.

``noise_impl``: the fused drivers resolve ``'auto'`` as JAX's do on the
chip (:func:`resolve_noise_impl`): the MXU-CLT generator
(``'hadamard_clt'``), or Box-Muller (``'box_muller'``) with ``pair_dots``;
the lanes, packed and stacked drivers (and ``FusedSGHMC``) have Box-Muller
only, as JAX's, and refuse ``'hadamard_clt'``.  ``'zero'`` is the
degenerate stream (zero noise, window 0 every step) that reproduces the JAX
kernels' interpret-mode Box-Muller stream for parity tests, on every
driver.

Spans (:mod:`pysgmcmc_tpu_torch.utils.tracing`, recorded only while a
profiler records): each fused driver call is ``fused.burn_in`` or
``fused.sample``.  Its prologue, from entry to the first kernel launch
(pack, casts, the data windows, the seed draw and the step read, which wait
for the card, the ε table and the kernel wrapper's checks), is read off
the trace by that launch's timestamp.  Each lanes driver call is
``lanes.burn_in`` or ``lanes.sample``, and each of its steps a
``lanes.gradient`` then a ``lanes.update`` (the slim kernel).
"""

import math
from typing import NamedTuple

import torch

from pysgmcmc_tpu_torch.ops.fused_step import (
    STATE_DTYPES,
    data_windows,
    fused_bnn_multistep,
    fused_bnn_multistep_burnin,
    fused_bnn_multistep_burnin_sgld,
    fused_bnn_multistep_psgld,
    fused_bnn_multistep_rsghmc,
    fused_bnn_multistep_sgld,
    fused_bnn_multistep_sgnht,
    fused_bnn_step,
    fused_bnn_step_psgld,
    fused_bnn_step_rsghmc,
    fused_bnn_step_sgld,
    fused_bnn_step_sgnht,
    fused_layout,
    gather_batch,
    pack,
    philox_windows,
    unpack,
)
from pysgmcmc_tpu_torch.ops.fused_update import pad_dim
from pysgmcmc_tpu_torch.ops.slim_update import (
    slim_psgld_update,
    slim_rsghmc_update,
    slim_sghmc_burnin_update,
    slim_sghmc_update,
    slim_sghmc_update_ref,
    slim_sghmc_update_tree,
    slim_sghmc_update_tree_ref,
    slim_sgld_burnin_update,
    slim_sgld_update,
    slim_sgnht_update,
)
from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.samplers.psgld import PSGLDSampler
from pysgmcmc_tpu_torch.samplers.relativistic_sghmc import (
    RelativisticSGHMCSampler,
)
from pysgmcmc_tpu_torch.samplers.sghmc import SGHMCSampler, SGHMCState
from pysgmcmc_tpu_torch.samplers.sgld import SGLDSampler, SGLDState
from pysgmcmc_tpu_torch.samplers.sgnht import SGNHTSampler
from pysgmcmc_tpu_torch.utils.tracing import span, spanned


# The most steps one launch of a paired kernel advances: JAX's drivers cut
# every launch there, and at bf16 state the paired kernels round the matrix
# slabs' momentum at each launch's end.
MAX_STEPS_PER_LAUNCH = 512

_NOISE_IMPLS = ("auto", "box_muller", "hadamard_clt", "zero")


def resolve_noise_impl(noise_impl, pair_dots=False):
    """The generator a fused driver uses for ``noise_impl``: ``'auto'`` ->
    ``'hadamard_clt'`` (the MXU-CLT generator), or ``'box_muller'`` with
    ``pair_dots`` (the paired kernels have Box-Muller only), as JAX's
    ``resolve_noise_impl`` on the chip; the port's CPU path draws the same
    stream as its kernels, so the resolution does not depend on the device.
    ``'box_muller'``, ``'hadamard_clt'`` and ``'zero'`` (the degenerate
    stream) pass through; others raise."""
    if noise_impl not in _NOISE_IMPLS:
        raise ValueError(
            "noise_impl must be 'auto', 'box_muller', 'hadamard_clt' or "
            "'zero'; got {!r}".format(noise_impl))
    if noise_impl == "auto":
        return "box_muller" if pair_dots else "hadamard_clt"
    return noise_impl


def box_muller_noise(name, noise_impl):
    """The generator of a driver that has Box-Muller only (the lanes,
    packed and stacked drivers, ``FusedSGHMC``; JAX's have no other):
    ``'auto'`` -> ``'box_muller'``, ``'zero'`` passes, ``'hadamard_clt'``
    raises."""
    if noise_impl not in ("auto", "box_muller", "zero"):
        raise ValueError(
            "{}: this driver draws Box-Muller normals only (noise_impl "
            "'auto', 'box_muller' or 'zero'; 'hadamard_clt' is the fused "
            "kernels' generator); got {!r}".format(name, noise_impl))
    return "box_muller" if noise_impl == "auto" else noise_impl


_KINDS = ((SGHMCSampler, "sghmc"), (SGLDSampler, "sgld"),
          (PSGLDSampler, "psgld"), (RelativisticSGHMCSampler, "rsghmc"),
          (SGNHTSampler, "sgnht"))


def _sampler_kind(name, sampler):
    """``"sghmc"``, ``"sgld"``, ``"psgld"``, ``"rsghmc"`` or ``"sgnht"``;
    raises on any other sampler."""
    for cls, kind in _KINDS:
        if isinstance(sampler, cls):
            return kind
    raise NotImplementedError(
        "{}: the port's drivers take the gradient samplers SGHMC, SGLD, "
        "PSGLD, RelativisticSGHMC and SGNHT; got {} (SVGD trains through "
        "BayesianNeuralNetwork's SVGD path, sampling_method=Sampler.SVGD, "
        "not through these drivers: ROADMAP.md queue A item 12)".format(
            name, type(sampler).__name__))


def _check_driver(name, sampler, mesh):
    """Raises on what the port's drivers do not take; returns the sampler's
    kind (:func:`_sampler_kind`)."""
    kind = _sampler_kind(name, sampler)
    if mesh is not None:
        raise NotImplementedError(
            "{}: mesh sharding is not ported yet (ROADMAP.md queue A item "
            "15)".format(name))
    return kind


def _check_burn_in(name, sampler):
    """Raises unless the sampler has burn-in machinery (SGHMC, SGLD);
    returns its kind."""
    kind = _sampler_kind(name, sampler)
    if kind not in ("sghmc", "sgld"):
        raise NotImplementedError(
            "{} supports the adaptive (burn-in) samplers SGHMC and SGLD; got "
            "{}, which has no burn-in machinery: run its burn-in as "
            "discarded steps of sample_chain_lanes".format(
                name, type(sampler).__name__))
    return kind


def _draw_seed(generator):
    """One 63-bit Philox key from ``generator`` (on its own device)."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=generator.device))


def _eps_table(sampler, schedule_state, step0, k_steps):
    value = sampler.stepsize_schedule.value
    return torch.tensor(
        [float(value(schedule_state, step0 + t)) for t in range(k_steps)],
        dtype=torch.float32)


def _stream_inputs(noise_impl, k_steps, n_chains, n_params, device):
    """The keywords of a fused launch for the generator ``noise_impl``:
    ``noise_impl``, and the zero ``noise`` and ``widx`` test inputs for
    ``'zero'`` (with Box-Muller, which reads them)."""
    if noise_impl != "zero":
        return dict(noise_impl=noise_impl)
    return dict(
        noise_impl="box_muller",
        noise=torch.zeros((k_steps, n_chains, n_params), dtype=torch.float32,
                          device=device),
        widx=torch.zeros((k_steps, n_chains), dtype=torch.int32,
                         device=device))


def _launch_segments(n_steps, pair_dots):
    """The step counts of the launches that advance ``n_steps`` steps: one
    launch, or with ``pair_dots`` launches of at most
    :data:`MAX_STEPS_PER_LAUNCH` steps, as JAX's drivers cut them."""
    n_steps = int(n_steps)
    if not pair_dots:
        return [n_steps]
    return ([MAX_STEPS_PER_LAUNCH] * (n_steps // MAX_STEPS_PER_LAUNCH)
            + ([n_steps % MAX_STEPS_PER_LAUNCH]
               if n_steps % MAX_STEPS_PER_LAUNCH else []))


def _data(x, y, batch_size, device):
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    x_win, y_win = data_windows(x, y, batch_size)
    return x_win, y_win, x.shape[0]


@spanned("fused.burn_in")
def burnin_chain_fused(sampler, states, key, n_steps, x, y, batch_size=20,
                       state_dtype=torch.bfloat16, mesh=None, pair_dots=False,
                       noise_impl="auto"):
    """Run ``n_steps`` burn-in steps of every chain in one B2 (SGHMC) or B6
    (SGLD) launch (with ``pair_dots``, launches of B2 or B6 paired of at
    most :data:`MAX_STEPS_PER_LAUNCH` steps each).

    ``states`` is a stacked :class:`SGHMCState` or :class:`SGLDState`
    (leaves ``(n_chains, ...)``) of dense-network positions, ``key`` a
    ``torch.Generator`` on the states' device, ``x``/``y`` the raw training
    data.  Returns the advanced states with ``stats.minv`` holding the
    mass-matrix inverse the final step used (the value the sampling phase
    freezes).

    ``state_dtype`` is the storage of SGHMC's momentum in the kernel,
    ``torch.bfloat16`` by default as in the JAX package's driver: the
    momentum is rounded to it before the launch and after every step, and
    comes back float32; tau, g, v_hat and minv stay float32 (SGLD has no
    momentum).  ``BayesianNeuralNetwork`` burns in with ``torch.float32``,
    as JAX's does.  ``noise_impl`` as :func:`resolve_noise_impl`.
    """
    name = "burnin_chain_fused"
    _check_burn_in(name, sampler)
    sghmc = _check_driver(name, sampler, mesh) == "sghmc"
    noise_impl = resolve_noise_impl(noise_impl, pair_dots)
    if int(n_steps) < 1:
        return states
    layout = fused_layout(states.position)
    theta = pack(states.position, layout)
    device = theta.device
    x_win, y_win, n_data = _data(x, y, batch_size, device)
    step0 = int(torch.max(states.step))
    n_steps = int(n_steps)
    stats = [pack(leaf, layout) for leaf in states.stats[:3]]  # tau, g, v_hat
    v = pack(states.momentum, layout).to(state_dtype) if sghmc else None
    seed = _draw_seed(key)
    eps = _eps_table(sampler, states.schedule_state, step0, n_steps)
    done = 0
    for seg in _launch_segments(n_steps, pair_dots):
        common = dict(
            scale_grad=sampler.scale_grad,
            prior_scale=sampler.gaussian_prior_scale, batch_size=batch_size,
            n_data=n_data, k_steps=seg, h=layout.hidden, step0=step0 + done,
            pair_dots=pair_dots, **_stream_inputs(
                noise_impl, seg, theta.shape[0], layout.n_params, device))
        seg_eps = eps[done:done + seg]
        if sghmc:
            theta, v, *stats, minv, _ = fused_bnn_multistep_burnin(
                theta, v, *stats, x_win, y_win, seg_eps, seed,
                mdecay=sampler.mdecay, state_dtype=state_dtype, **common)
        else:
            theta, *stats, minv, _ = fused_bnn_multistep_burnin_sgld(
                theta, *stats, x_win, y_win, seg_eps, seed,
                a_coef=sampler.A, **common)
        done += seg
    tau, g, v_hat = stats
    fields = dict(
        position=unpack(theta, layout),
        stats=AdaptiveStats(
            tau=unpack(tau, layout), g=unpack(g, layout),
            v_hat=unpack(v_hat, layout), minv=unpack(minv, layout)),
        step=states.step + n_steps,
        schedule_state=states.schedule_state,
    )
    if sghmc:
        return SGHMCState(momentum=unpack(v.float(), layout), **fields)
    return SGLDState(**fields)


# sampler kind -> (multi-step kernel, one-step kernel) of sample_chain_fused
_FUSED_KERNELS = {
    "sghmc": (fused_bnn_multistep, fused_bnn_step),                # B1, B3
    "sgld": (fused_bnn_multistep_sgld, fused_bnn_step_sgld),
    "psgld": (fused_bnn_multistep_psgld, fused_bnn_step_psgld),
    "sgnht": (fused_bnn_multistep_sgnht, fused_bnn_step_sgnht),
    "rsghmc": (fused_bnn_multistep_rsghmc, fused_bnn_step_rsghmc),
}


def _fused_rule(kind, sampler, state_dtype):
    """The keywords of the sampler's fused kernels, as the sampler sets
    them (the prior scale and, but for relativistic SGHMC, scale_grad
    included); the momentum's ``state_dtype`` where the sampler has one."""
    rule = _lanes_rule(kind, sampler)
    if kind == "rsghmc":
        rule["b_hat"] = rule.pop("bhat")
    if kind in ("sghmc", "sgnht", "rsghmc"):
        rule["state_dtype"] = state_dtype
    return rule


@spanned("fused.sample")
def sample_chain_fused(sampler, states, key, n_samples, x, y, batch_size=20,
                       keep_every=1, state_dtype=torch.bfloat16,
                       collect_positions=True, mesh=None, multistep=False,
                       pair_dots=False, noise_impl="auto"):
    """Sampling-phase driver: ``n_samples`` collected samples, each after
    ``keep_every`` steps of every chain (SGHMC and SGLD with the frozen
    ``stats.minv``; pSGLD's accumulator, SGNHT's thermostat and the
    momenta move with the chains).

    ``multistep=True`` advances the ``keep_every`` steps in one launch of B1
    (SGHMC), B5-sgld, B5-psgld, B5-sgnht or B5-rsghmc (with ``pair_dots``,
    launches of their paired variants of at most
    :data:`MAX_STEPS_PER_LAUNCH` steps each); ``multistep=False``
    launches B3 / B4-sgld / B4-psgld / B4-sgnht / B4-rsghmc once per step on
    the windows :func:`philox_windows` draws for that step (window 0 under
    ``noise_impl='zero'``), which gives the multi-step kernels' chains.  An
    SGNHT ``xi`` may be a shared scalar or ``(n_chains,)`` and comes back
    ``(n_chains,)``.  Returns ``(states, positions, costs)``: ``positions``
    stacks the position after each sample as leaves ``(n_chains, n_samples,
    ...)`` (``None`` without ``collect_positions``), ``costs`` is
    ``(n_chains, n_samples)``, each sample's final-step cost.

    ``state_dtype`` is the storage of the momentum (SGHMC, SGNHT,
    relativistic SGHMC) and of SGHMC's and SGLD's frozen minv in the
    kernels, ``torch.bfloat16`` by default as in the JAX package's driver:
    they are rounded to it before the first launch, the momentum again
    after every step, and the momentum comes back float32.  pSGLD's
    accumulator stays float32 whatever ``state_dtype`` says, as in JAX.
    ``noise_impl`` as :func:`resolve_noise_impl`.
    """
    name = "sample_chain_fused"
    kind = _check_driver(name, sampler, mesh)
    if pair_dots and not multistep:
        raise ValueError(
            "pair_dots is a multi-step kernel variant; pass multistep=True")
    noise_impl = resolve_noise_impl(noise_impl, pair_dots)
    layout = fused_layout(states.position)
    theta = pack(states.position, layout)
    device = theta.device
    n = theta.shape[0]
    v = minv = xi = None
    if kind == "psgld":  # the accumulator adapts every step and stays f32
        v = pack(states.v, layout)
        state_dtype = torch.float32
    elif kind != "sgld":
        v = pack(states.momentum, layout).to(state_dtype)
    if kind in ("sghmc", "sgld"):
        minv = pack(states.stats.minv, layout).to(state_dtype)
    if kind == "sgnht":
        xi = _lanes_xi(name, states, n, device)
    x_win, y_win, n_data = _data(x, y, batch_size, device)
    seed = _draw_seed(key)
    step = int(torch.max(states.step))
    multi_kernel, one_kernel = _FUSED_KERNELS[kind]
    common = dict(batch_size=batch_size, n_data=n_data, h=layout.hidden,
                  **_fused_rule(kind, sampler, state_dtype))

    def launch(kernel, theta, v, xi, x, y, eps, **kw):
        # the kernels take (theta, v?, xi?, minv?, x, y, ...) and return
        # (theta', v'?, xi'?, cost), each state where the rule has it
        out = list(kernel(*[t for t in (theta, v, xi, minv) if t is not None],
                          x, y, eps, seed, **common, **kw))
        theta = out.pop(0)
        v = None if v is None else out.pop(0)
        xi = None if xi is None else out.pop(0)
        return theta, v, xi, out[0]

    def multistep_launch(theta, v, xi, step, k):
        return launch(multi_kernel, theta, v, xi, x_win, y_win,
                      _eps_table(sampler, states.schedule_state, step, k),
                      k_steps=k, step0=step, pair_dots=pair_dots,
                      **_stream_inputs(noise_impl, k, n, layout.n_params,
                                       device))

    def one_step_launch(theta, v, xi, step):
        if noise_impl == "zero":
            widx = torch.zeros(n, dtype=torch.int64, device=device)
            stream = dict(noise=torch.zeros(
                (n, layout.n_params), dtype=torch.float32, device=device))
        else:
            widx = philox_windows(seed, step, n, x_win.shape[0], device)
            stream = dict(noise_impl=noise_impl)
        return launch(one_kernel, theta, v, xi,
                      *gather_batch(x_win, y_win, widx),
                      _eps_table(sampler, states.schedule_state, step, 1),
                      n_inputs=layout.n_inputs, step=step, **stream)

    positions, costs = [], []
    for _ in range(int(n_samples)):
        if multistep:
            for seg in _launch_segments(keep_every, pair_dots):
                theta, v, xi, cost = multistep_launch(theta, v, xi, step, seg)
                step += seg
        else:
            for _ in range(keep_every):
                theta, v, xi, cost = one_step_launch(theta, v, xi, step)
                step += 1
        if collect_positions:
            positions.append(unpack(theta, layout))
        costs.append(cost[:, 0])
    moved = dict(position=unpack(theta, layout))
    if kind == "psgld":
        moved["v"] = unpack(v, layout)
    elif v is not None:
        moved["momentum"] = unpack(v.float(), layout)
    if xi is not None:
        moved["xi"] = xi
    return _sampling_result(states, int(n_samples) * keep_every, positions,
                            costs, collect_positions, moved)


def _sampling_result(states, n_steps, positions, costs, collect_positions,
                     moved):
    """``(states, positions, costs)`` of a sampling driver: ``states`` with
    the fields in ``moved`` (position, and momentum, accumulator or
    thermostat where the sampler has them) replaced and the step counter
    advanced by ``n_steps``, the collected positions as leaves ``(n_chains,
    n_samples, ...)`` and the costs ``(n_chains, n_samples)``."""
    new_states = states._replace(step=states.step + n_steps, **moved)
    if collect_positions:
        positions = {name: torch.stack([p[name] for p in positions], dim=1)
                     for name in positions[0]}
    else:
        positions = None
    return new_states, positions, torch.stack(costs, dim=1)


#  Chains on lanes --------------------------------------------------------------

class LanesSpec(NamedTuple):
    """Column layout of a parameter dict packed chains-on-lanes."""

    names: tuple     # leaf names in storage order
    shapes: tuple    # per-leaf shapes (without the chain axis)
    sizes: tuple     # per-leaf element counts
    offsets: tuple   # first column of each leaf
    width: int       # P, the length of a chain's row


def make_lanes_spec(template):
    """Layout for :func:`pack_lanes` from a single-chain dict: the leaves
    in the dict's order, each a run of columns, no padding.  (The TPU
    layout, ``(rows, n_chains)`` with 8-aligned slots rounded up to 256
    rows, is the Mosaic compiler's choice and does not carry over.)"""
    names = tuple(template)
    shapes = tuple(tuple(template[name].shape) for name in names)
    sizes = tuple(math.prod(shape) for shape in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return LanesSpec(names, shapes, sizes, offsets, sum(sizes))


def _in_row(leaf, width, shape):
    """Whether ``leaf`` ``(n_chains, *shape)`` lies along the rows of a
    ``(n_chains, width)`` buffer as :func:`unpack_lanes` lays it (the
    strides of its dimensions longer than 1)."""
    want, step = [], 1
    for size in reversed(shape):
        want.insert(0, step)
        step *= size
    return all(got == expect for got, expect, size in zip(
        leaf.stride(), [width] + want, leaf.shape) if size > 1)


def _packed_base(spec, stacked, dtype):
    """The ``(n_chains, P)`` ``dtype`` buffer whose :func:`unpack_lanes`
    views the leaves of ``stacked`` are, in the spec's layout, or
    ``None``."""
    first = stacked[spec.names[0]]
    base = first._base
    if base is None or base.dtype != dtype \
            or tuple(base.shape) != (first.shape[0], spec.width) \
            or not base.is_contiguous():
        return None
    for name, off, shape in zip(spec.names, spec.offsets, spec.shapes):
        leaf = stacked[name]
        if leaf._base is not base \
                or leaf.storage_offset() != base.storage_offset() + off \
                or not _in_row(leaf, spec.width, shape):
            return None
    return base


def pack_lanes(spec, stacked, dtype=torch.float32):
    """Stacked dict (leaves ``(n_chains, *shape)``) -> ``(n_chains, P)``.
    The leaves go in the spec's order, whatever the order of ``stacked``.
    Leaves that are :func:`unpack_lanes` views of one ``dtype`` buffer give
    that buffer itself, uncopied (the drivers never write into their
    inputs)."""
    n = stacked[spec.names[0]].shape[0]
    for name, shape in zip(spec.names, spec.shapes):
        if tuple(stacked[name].shape) != (n,) + shape:
            raise ValueError(
                "pack_lanes: leaf {!r} is {}, the spec wants {}".format(
                    name, tuple(stacked[name].shape), (n,) + shape))
    base = _packed_base(spec, stacked, dtype)
    if base is not None:
        return base
    return torch.cat([stacked[name].reshape(n, size).to(dtype)
                      for name, size in zip(spec.names, spec.sizes)],
                     dim=1).contiguous()


def unpack_lanes(spec, flat, dtype=None):
    """``(n_chains, P)`` -> stacked dict in the spec's order, of views into
    ``flat`` (copies when ``dtype`` casts)."""
    n = flat.shape[0]
    out = {}
    for name, off, size, shape in zip(spec.names, spec.offsets, spec.sizes,
                                      spec.shapes):
        leaf = flat[:, off:off + size].reshape((n,) + shape)
        out[name] = leaf if dtype is None else leaf.to(dtype)
    return out


def _lanes_eps_fn(sampler, states, n_chains):
    """Per-step stepsize of the chains-on-lanes drivers: ``eps_of(step)``.

    With a schedule state stacked per chain (a tensor with a leading
    ``n_chains`` axis: the :class:`~pysgmcmc_tpu_torch.stepsize_schedules.
    TracedStepsizeSchedule` sweep pattern) it is an ``(n_chains,)`` float32
    vector, and the slim kernels advance every chain at its own stepsize;
    otherwise the float the schedule gives.
    """
    value = sampler.stepsize_schedule.value
    state = states.schedule_state
    if (torch.is_tensor(state) and state.ndim >= 1
            and state.shape[0] == n_chains):
        def eps_of(step):
            return torch.func.vmap(lambda s: torch.as_tensor(
                value(s, step), dtype=torch.float32))(state)
        return eps_of

    def eps_of(step):
        return float(value(state, step))
    return eps_of


def _check_lanes(name, sampler, mesh, compute_dtype, state_dtype):
    """Raises on what the lanes drivers do not take; returns the sampler's
    kind (:func:`_sampler_kind`)."""
    kind = _check_driver(name, sampler, mesh)
    if compute_dtype is not None and compute_dtype not in STATE_DTYPES:
        raise ValueError(
            "{}: compute_dtype must be None, torch.float32 or "
            "torch.bfloat16; got {}".format(name, compute_dtype))
    if state_dtype not in STATE_DTYPES:
        raise ValueError(
            "{}: state_dtype must be torch.float32 or torch.bfloat16; got "
            "{}".format(name, state_dtype))
    return kind


def _stacked_gradient(sampler, position, batch_fn, window_seed, step):
    """Every chain's cost and stacked gradient dict at ``position`` (leaves
    in the network's type) on the windows of ``step``: ``torch.func.vmap``
    over the chains, or with one chain plain autograd on its leaves, which
    takes a network whose shapes depend on the data (a dropless expert
    layer's tokens per expert), as ``vmap`` does not."""
    n = next(iter(position.values())).shape[0]
    if n == 1:
        return _one_chain_gradient(sampler, position, batch_fn, window_seed,
                                   step)
    if batch_fn is None:
        grads, cost = torch.func.vmap(torch.func.grad_and_value(
            lambda pos: sampler.cost_fn(pos)))(position)
    else:
        grads, cost = torch.func.vmap(torch.func.grad_and_value(
            sampler.cost_fn))(position, batch_fn(window_seed, step, n))
    return cost, grads


def _one_chain_gradient(sampler, position, batch_fn, window_seed, step):
    """:func:`_stacked_gradient` of one chain, without ``vmap``."""
    params = {name: leaf[0].detach().requires_grad_()
              for name, leaf in position.items()}
    batch = () if batch_fn is None else (
        tuple(b[0] for b in batch_fn(window_seed, step, 1)),)
    with torch.enable_grad():
        cost = sampler.cost_fn(params, *batch)
    grads = torch.autograd.grad(cost, list(params.values()),
                                materialize_grads=True)
    return cost.detach()[None], {name: g[None]
                                 for name, g in zip(params, grads)}


def _lanes_gradient(sampler, spec, theta, batch_fn, window_seed, step,
                    compute_dtype=None):
    """Every chain's cost ``(n_chains,)`` and packed gradient at ``theta``,
    on the minibatch ``batch_fn(window_seed, step, n_chains)`` (the full
    data without a ``batch_fn``).  The network pass runs on ``theta``'s
    leaves cast to ``compute_dtype`` (``None``: float32), and the gradient
    is packed in the type it comes in (bf16 under bf16 leaves), as JAX's
    lanes drivers do."""
    cost, grads = _stacked_gradient(
        sampler, unpack_lanes(spec, theta, compute_dtype), batch_fn,
        window_seed, step)
    return cost, pack_lanes(spec, grads,
                            dtype=next(iter(grads.values())).dtype)


def _lanes_rule(kind, sampler):
    """The keywords of the sampler's slim kernel, as the sampler sets them."""
    if kind == "rsghmc":
        return dict(d_coef=sampler.D, bhat=sampler.Bhat, mass=sampler.mass,
                    speed_of_light=sampler.speed_of_light,
                    prior_scale=sampler.gaussian_prior_scale)
    rule = dict(scale_grad=sampler.scale_grad,
                prior_scale=sampler.gaussian_prior_scale)
    if kind == "sghmc":
        rule["mdecay"] = sampler.mdecay
    elif kind == "sgld":
        rule["a_coef"] = sampler.A
    elif kind == "psgld":
        rule.update(alpha=sampler.alpha, lambda_reg=sampler.lambda_reg)
    else:
        rule["a_diff"] = sampler.a_diff
    return rule


def _lanes_xi(name, states, n_chains, device):
    """SGNHT's thermostat as ``(n_chains,)`` float32: a shared scalar (the
    ``init`` of stacked positions) is given to every chain."""
    xi = torch.as_tensor(states.xi, dtype=torch.float32, device=device)
    if xi.ndim == 0:
        return xi.expand(n_chains).contiguous()
    if tuple(xi.shape) != (n_chains,):
        raise ValueError(
            "{}: xi must be a scalar or one per chain ({},); got {}".format(
                name, n_chains, tuple(xi.shape)))
    return xi.contiguous()


def _lanes_start(name, sampler, states, key, compute_dtype, state_dtype,
                 mesh, noise_impl):
    """What both lanes drivers set up: ``(kind, spec, theta, v, step0,
    eps_of, seed, window_seed, rule keywords)``; ``v`` is the packed
    momentum (SGHMC, RSGHMC, SGNHT) or accumulator (pSGLD) in
    ``state_dtype``, ``None`` for SGLD."""
    kind = _check_lanes(name, sampler, mesh, compute_dtype, state_dtype)
    zero = box_muller_noise(name, noise_impl) == "zero"
    spec = make_lanes_spec({k: leaf[0] for k, leaf in states.position.items()})
    theta = pack_lanes(spec, states.position)
    if kind == "sgld":
        v = None
    else:
        v = pack_lanes(spec, states.v if kind == "psgld"
                       else states.momentum, dtype=state_dtype)
    seed = _draw_seed(key)
    rule = dict(_lanes_rule(kind, sampler),
                noise=torch.zeros_like(theta) if zero else None)
    return (kind, spec, theta, v, int(torch.max(states.step)),
            _lanes_eps_fn(sampler, states, theta.shape[0]), seed,
            None if zero else seed, rule)


@spanned("lanes.burn_in")
def burnin_chain_lanes(sampler, states, key, n_steps, batch_fn=None,
                       compute_dtype=torch.bfloat16,
                       state_dtype=torch.float32, mesh=None,
                       noise_impl="auto"):
    """Run ``n_steps`` self-tuning burn-in steps of every chain, one launch
    of B9-sghmc (SGHMC) or B9-sgld (SGLD) per step.

    ``states`` is a stacked :class:`SGHMCState` or :class:`SGLDState`
    (leaves ``(n_chains, ...)``) of any network, ``key`` a
    ``torch.Generator``, ``batch_fn`` a selector of
    :func:`pysgmcmc_tpu_torch.data_batches.batch_fn` (``None``: the cost
    takes no batch).  Returns the advanced states, with ``stats.minv``
    holding the mass-matrix inverse the final step used (the value the
    sampling phase freezes).

    As in the JAX package's driver, each step's network pass runs on the
    position cast to ``compute_dtype`` (``torch.bfloat16`` by default;
    ``None`` keeps float32) and its gradient reaches the kernel in that
    type; SGHMC's momentum is stored in ``state_dtype`` (float32 by
    default) and comes back float32; tau, g, v_hat and minv are float32.
    """
    name = "burnin_chain_lanes"
    _check_burn_in(name, sampler)
    if int(n_steps) < 1:
        return states
    kind, spec, theta, v, step0, eps_of, seed, window_seed, rule = \
        _lanes_start(name, sampler, states, key, compute_dtype, state_dtype,
                     mesh, noise_impl)
    sghmc = kind == "sghmc"
    tau, g, v_hat = (pack_lanes(spec, leaf) for leaf in states.stats[:3])
    n_steps = int(n_steps)
    for step in range(step0, step0 + n_steps):
        with span("lanes.gradient"):
            _, grad = _lanes_gradient(sampler, spec, theta, batch_fn,
                                      window_seed, step, compute_dtype)
        with span("lanes.update"):
            if sghmc:
                theta, v, tau, g, v_hat, minv = slim_sghmc_burnin_update(
                    theta, v, tau, g, v_hat, grad, None, eps_of(step), seed,
                    step=step, **rule)
            else:
                theta, tau, g, v_hat, minv = slim_sgld_burnin_update(
                    theta, tau, g, v_hat, grad, None, eps_of(step), seed,
                    step=step, **rule)
    fields = dict(
        position=unpack_lanes(spec, theta),
        stats=AdaptiveStats(
            tau=unpack_lanes(spec, tau), g=unpack_lanes(spec, g),
            v_hat=unpack_lanes(spec, v_hat), minv=unpack_lanes(spec, minv)),
        step=states.step + n_steps,
        schedule_state=states.schedule_state,
    )
    if sghmc:
        return SGHMCState(momentum=unpack_lanes(spec, v, torch.float32),
                          **fields)
    return SGLDState(**fields)


def _lanes_update(kind, spec, theta, v, grad, minv, xi, eps, seed, step,
                  rule):
    """One sampling step's slim kernel: ``(theta, v, xi)`` after it (``v``
    ``None`` for SGLD, ``xi`` moved for SGNHT only)."""
    if kind == "sghmc":
        theta, v = slim_sghmc_update(theta, v, grad, minv, None, eps, seed,
                                     step=step, **rule)
    elif kind == "sgld":
        theta = slim_sgld_update(theta, grad, minv, None, eps, seed,
                                 step=step, **rule)
    elif kind == "psgld":
        theta, v = slim_psgld_update(theta, v, grad, None, eps, seed,
                                     step=step, **rule)
    elif kind == "rsghmc":
        theta, v = slim_rsghmc_update(theta, v, grad, None, eps, seed,
                                      step=step, **rule)
    else:
        theta, v = slim_sgnht_update(theta, v, grad, None, xi, eps, seed,
                                     step=step, **rule)
        # the thermostat: one reduction over every chain's row of the
        # stored momentum (a float eps stays a host scalar: no copy, no
        # stream wait)
        if torch.is_tensor(eps):
            eps = eps.to(xi.device)
        p = v.float()
        xi = xi + eps * (torch.sum(p * p, dim=1) / spec.width - 1.0)
    return theta, v, xi


@spanned("lanes.sample")
def sample_chain_lanes(sampler, states, key, n_samples, batch_fn=None,
                       keep_every=1, compute_dtype=torch.bfloat16,
                       state_dtype=torch.float32, collect_positions=True,
                       mesh=None, noise_impl="auto"):
    """Sampling-phase driver on the chains-on-lanes kernels: ``n_samples``
    collected samples, each after ``keep_every`` steps of every chain, one
    slim launch per step: B7 (SGHMC) or B8-sgld (SGLD) with the frozen
    ``stats.minv``, B8-psgld (pSGLD), B8-rsghmc (relativistic SGHMC) or
    B8-sgnht (SGNHT, whose per-chain thermostat then moves by ``eps (p'^T
    p' / P - 1)``).  ``states`` is a stacked state of any of the five
    samplers; an SGNHT ``xi`` may be a shared scalar or ``(n_chains,)``
    and comes back ``(n_chains,)``.  Other arguments as
    :func:`burnin_chain_lanes`; the momentum or accumulator and SGHMC's and
    SGLD's frozen minv are stored in ``state_dtype``, and SGNHT's
    thermostat sums the stored (rounded) momentum, as JAX's lanes driver
    does.  Returns ``(states, positions, costs)`` shaped as
    :func:`sample_chain_fused`'s (the momentum or accumulator float32); a
    sample's cost is that of its final step's gradient pass.
    """
    kind, spec, theta, v, step, eps_of, seed, window_seed, rule = \
        _lanes_start("sample_chain_lanes", sampler, states, key,
                     compute_dtype, state_dtype, mesh, noise_impl)
    minv = (pack_lanes(spec, states.stats.minv, dtype=state_dtype)
            if kind in ("sghmc", "sgld") else None)
    xi = _lanes_xi("sample_chain_lanes", states, theta.shape[0],
                   theta.device) if kind == "sgnht" else None
    positions, costs = [], []
    for _ in range(int(n_samples)):
        for _ in range(keep_every):
            with span("lanes.gradient"):
                cost, grad = _lanes_gradient(sampler, spec, theta, batch_fn,
                                             window_seed, step, compute_dtype)
            with span("lanes.update"):
                theta, v, xi = _lanes_update(kind, spec, theta, v, grad,
                                             minv, xi, eps_of(step), seed,
                                             step, rule)
            step += 1
        if collect_positions:
            positions.append(unpack_lanes(spec, theta))
        costs.append(cost)
    moved = dict(position=unpack_lanes(spec, theta))
    if kind in ("sghmc", "rsghmc", "sgnht"):
        moved["momentum"] = unpack_lanes(spec, v, torch.float32)
    elif kind == "psgld":
        moved["v"] = unpack_lanes(spec, v, torch.float32)
    if kind == "sgnht":
        moved["xi"] = xi
    return _sampling_result(states, int(n_samples) * keep_every, positions,
                            costs, collect_positions, moved)


#  Packed slots and the stacked tree (SGHMC sampling) ---------------------------

class PackSpec(NamedTuple):
    """Layout of a parameter dict packed into 128-aligned column slots
    (JAX's public slot layout; ``names`` stands for JAX's treedef)."""

    names: tuple     # leaf names in slot order: the keys sorted, as JAX's
                     # tree_flatten orders a dict
    shapes: tuple    # per-leaf shapes (without the chain axis)
    sizes: tuple     # per-leaf element counts
    offsets: tuple   # slot start columns
    width: int       # total packed width (multiple of 128)


def make_pack_spec(template):
    """The slot layout of a single-chain parameter dict.

    >>> spec = make_pack_spec({"w": torch.zeros(2, 3), "b": torch.zeros(2)})
    >>> spec.names, spec.offsets, spec.width  # two leaves, two slots
    (('b', 'w'), (0, 128), 256)
    """
    names = tuple(sorted(template))
    shapes = tuple(tuple(template[name].shape) for name in names)
    sizes = tuple(math.prod(shape) for shape in shapes)
    offsets, off = [], 0
    for size in sizes:
        offsets.append(off)
        off += pad_dim(size)
    return PackSpec(names, shapes, sizes, tuple(offsets), off)


def pack_mask(spec, dtype=torch.float32, device="cuda"):
    """``(1, width)`` mask: 1 on real columns, 0 on slot padding, on the
    card unless ``device="cpu"``.

    >>> spec = make_pack_spec({"w": torch.zeros(2, 3), "b": torch.zeros(2)})
    >>> mask = pack_mask(spec, device="cpu")
    >>> mask.shape, int(mask.sum()), mask[0, :3].tolist()
    (torch.Size([1, 256]), 8, [1.0, 1.0, 0.0])
    """
    mask = torch.zeros((1, spec.width), dtype=dtype)
    for off, size in zip(spec.offsets, spec.sizes):
        mask[0, off:off + size] = 1.0
    return mask.to(device)


def pack_tree(spec, stacked, dtype=torch.float32):
    """Stacked dict (leaves ``(n, *shape)``) -> dense ``(n, width)``, the
    padding 0."""
    n = stacked[spec.names[0]].shape[0]
    parts = []
    for name, size in zip(spec.names, spec.sizes):
        flat = stacked[name].reshape(n, size).to(dtype)
        parts.append(torch.nn.functional.pad(flat, (0, pad_dim(size) - size)))
    return torch.cat(parts, dim=1)


def unpack_tree(spec, flat, dtype=None):
    """Dense ``(n, width)`` -> stacked dict in slot order, optionally cast
    to ``dtype``."""
    n = flat.shape[0]
    out = {}
    for name, off, size, shape in zip(spec.names, spec.offsets, spec.sizes,
                                      spec.shapes):
        leaf = flat[:, off:off + size].reshape((n,) + shape)
        out[name] = leaf if dtype is None else leaf.to(dtype)
    return out


def _noise_index(spec, template):
    """The packed slab's int32 ``(width,)`` row of noise elements: a real
    column's element is its index in the chain's unpadded row with the
    leaves in ``template``'s order (the lanes layout's), a padding
    column's lies past that row (its momentum is masked to 0)."""
    lanes = make_lanes_spec(template)
    lanes_off = dict(zip(lanes.names, lanes.offsets))
    index = torch.arange(spec.width, dtype=torch.int64) + lanes.width
    for name, off, size in zip(spec.names, spec.offsets, spec.sizes):
        index[off:off + size] = torch.arange(size) + lanes_off[name]
    return index.to(torch.int32)


def _shared_schedule_state(states, driver="this driver"):
    """Collapse a stacked per-chain schedule state to the shared one.

    The packed and stacked drivers advance all chains at ONE stepsize, so a
    stacked schedule state (a tensor with a leading chain axis) is only
    admissible when every chain carries the same value; heterogeneous
    states raise instead of running every chain at chain 0's stepsize (use
    :func:`sample_chain_lanes`, which takes per-chain stepsizes).
    """
    state = states.schedule_state
    if not torch.is_tensor(state) or state.ndim < 1:
        return state
    if not bool((state == state[:1]).all()):
        raise ValueError(
            "{}: chains carry heterogeneous per-chain schedule state, but "
            "this driver advances all chains at one shared stepsize.  Use "
            "sample_chain_lanes (which supports per-chain stepsizes) for "
            "stepsize sweeps.".format(driver))
    return state[0]


def _sghmc_start(name, sampler, states, key, backend, noise_impl, interpret):
    """What the packed and stacked drivers set up: raises on what they do
    not take; returns ``(step0, eps_of, seed, window_seed, zero, rule
    keywords)``."""
    if not isinstance(sampler, SGHMCSampler):
        raise NotImplementedError(
            "{} currently supports SGHMCSampler; got {!r}".format(
                name, type(sampler).__name__))
    if backend not in ("pallas", "xla"):
        raise ValueError("backend must be 'pallas' or 'xla'")
    zero = box_muller_noise(name, noise_impl) == "zero"
    first = next(iter(states.position.values()))
    if interpret and first.device.type != "cpu":
        raise ValueError(
            "{}: interpret=True runs the plain versions, on CPU tensors "
            "only; CUDA tensors launch the kernels (pass interpret=False)"
            .format(name))
    schedule_state = _shared_schedule_state(states, name)
    value = sampler.stepsize_schedule.value
    seed = _draw_seed(key)
    return (int(torch.max(states.step)),
            lambda step: float(value(schedule_state, step)), seed,
            None if zero else seed, zero,
            dict(mdecay=sampler.mdecay, scale_grad=sampler.scale_grad,
                 prior_scale=sampler.gaussian_prior_scale))


def _sghmc_result(states, position, momentum, n_steps, positions, costs,
                  collect_positions):
    """The sampling drivers' ``(states, positions, costs)``, every dict in
    the order of ``states.position``."""
    def ordered(tree):
        return {name: tree[name] for name in states.position}

    return _sampling_result(
        states, n_steps, [ordered(p) for p in positions], costs,
        collect_positions,
        dict(position=ordered(position), momentum=ordered(momentum)))


def sample_chain_stacked(sampler, states, key, n_samples, batch_fn=None,
                         keep_every=1, backend="pallas", bf16_params=False,
                         collect_positions=True, interpret=False,
                         noise_impl="auto"):
    """Sampling-phase SGHMC driver over stacked (native-layout) state: each
    step the vmapped gradient on the leaves as they are, then one launch of
    B7' (:func:`~pysgmcmc_tpu_torch.ops.slim_update.
    slim_sghmc_update_tree`) for every leaf, with the frozen
    ``stats.minv``.

    ``states`` is a stacked :class:`SGHMCState` (leaves ``(n_chains,
    ...)``, after burn-in), ``key`` a ``torch.Generator`` (the Philox key
    and the windows' seed are drawn from it as :func:`sample_chain_lanes`
    draws them), ``batch_fn`` a selector of :func:`pysgmcmc_tpu_torch.
    data_batches.batch_fn`.  With ``bf16_params`` the cost runs on the
    bfloat16 copy of the position that B7' emits each step (its gradient
    stays bfloat16; the cost function must take bf16 leaves).
    ``backend="xla"`` runs the same math in plain PyTorch with the normals
    drawn from ``key``.  ``noise_impl="zero"`` is the degenerate stream
    (zero noise, window 0), ``interpret=True`` runs the plain versions (CPU
    tensors only).  Returns ``(states, positions, costs)`` like
    :func:`sample_chain_lanes`.
    """
    name = "sample_chain_stacked"
    step, eps_of, seed, window_seed, zero, rule = _sghmc_start(
        name, sampler, states, key, backend, noise_impl, interpret)
    # float32 and contiguous, as B7' reads every leaf in place
    theta, v, minv = ({k: leaf.float().contiguous() for k, leaf in
                       tree.items()} for tree in (
        states.position, states.momentum, states.stats.minv))
    theta_c = ({k: leaf.to(torch.bfloat16) for k, leaf in theta.items()}
               if bf16_params else None)
    update = slim_sghmc_update_tree_ref if interpret or backend == "xla" \
        else slim_sghmc_update_tree
    positions, costs = [], []
    for _ in range(int(n_samples)):
        for _ in range(keep_every):
            cost, grads = _stacked_gradient(
                sampler, theta_c if bf16_params else theta, batch_fn,
                window_seed, step)
            grads = {k: g.contiguous() for k, g in grads.items()}
            noise = None
            if zero:
                noise = {k: torch.zeros_like(t) for k, t in theta.items()}
            elif backend == "xla":
                noise = {k: torch.randn(t.shape, generator=key,
                                        device=key.device).to(t.device)
                         for k, t in theta.items()}
            out = update(theta, v, grads, minv, eps_of(step), seed,
                         noise=noise, emit_bf16=bf16_params, step=step,
                         **rule)
            theta, v = out[0], out[1]
            if bf16_params:
                theta_c = out[2]
            step += 1
        if collect_positions:
            positions.append(theta)
        costs.append(cost)
    return _sghmc_result(states, theta, v, int(n_samples) * keep_every,
                         positions, costs, collect_positions)


def sample_chain_packed(sampler, states, key, n_samples, batch_fn=None,
                        keep_every=1, compute_dtype=torch.bfloat16,
                        backend="pallas", collect_positions=True,
                        interpret=False, noise_impl="auto"):
    """Sampling-phase SGHMC driver over packed flat state: the position,
    momentum and frozen minv as ``(n_chains, width)`` slabs in JAX's slot
    layout (:func:`make_pack_spec`); each step unpacks the position into
    ``compute_dtype`` leaves (``torch.bfloat16`` by default, as JAX's;
    ``None`` keeps float32), takes the vmapped gradient, packs it in its
    own type and makes one launch of B7 mask
    (:func:`~pysgmcmc_tpu_torch.ops.slim_update.slim_sghmc_update` with
    :func:`pack_mask`), which keeps the slot padding of the momentum and
    the position at 0.  Other arguments and the result as
    :func:`sample_chain_stacked`'s; the states come back float32, in the
    position dict's order.
    """
    name = "sample_chain_packed"
    step, eps_of, seed, window_seed, zero, rule = _sghmc_start(
        name, sampler, states, key, backend, noise_impl, interpret)
    if compute_dtype is not None and compute_dtype not in STATE_DTYPES:
        raise ValueError(
            "{}: compute_dtype must be None, torch.float32 or "
            "torch.bfloat16; got {}".format(name, compute_dtype))
    spec = make_pack_spec({k: leaf[0] for k, leaf in states.position.items()})
    theta = pack_tree(spec, states.position)
    device = theta.device
    v = pack_tree(spec, states.momentum)
    minv = pack_tree(spec, states.stats.minv)
    mask = pack_mask(spec, device=device)
    noise_index = _noise_index(
        spec, {k: leaf[0] for k, leaf in states.position.items()}).to(device)
    update = slim_sghmc_update_ref if interpret or backend == "xla" \
        else slim_sghmc_update
    positions, costs = [], []
    for _ in range(int(n_samples)):
        for _ in range(keep_every):
            cost, grads = _stacked_gradient(
                sampler, unpack_tree(spec, theta, compute_dtype), batch_fn,
                window_seed, step)
            grad = pack_tree(spec, grads,
                             dtype=next(iter(grads.values())).dtype)
            noise = None
            if zero:
                noise = torch.zeros_like(theta)
            elif backend == "xla":
                noise = torch.randn(theta.shape, generator=key,
                                    device=key.device).to(device)
            theta, v = update(theta, v, grad, minv, mask, eps_of(step), seed,
                              noise=noise, step=step,
                              noise_index=noise_index, **rule)
            step += 1
        if collect_positions:
            positions.append(unpack_tree(spec, theta))
        costs.append(cost)
    return _sghmc_result(states, unpack_tree(spec, theta),
                         unpack_tree(spec, v), int(n_samples) * keep_every,
                         positions, costs, collect_positions)
