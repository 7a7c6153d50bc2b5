"""Chain drivers over the fused BNN kernels (PyTorch port of the fused
drivers of :mod:`pysgmcmc_tpu.parallel.packed`).

:func:`burnin_chain_fused` runs the whole self-tuning burn-in of every chain
as one launch of kernel B2 (:func:`~pysgmcmc_tpu_torch.ops.fused_step.
fused_bnn_multistep_burnin`); :func:`sample_chain_fused` runs the sampling
phase as one launch of kernel B1 (:func:`~pysgmcmc_tpu_torch.ops.fused_step.
fused_bnn_multistep`) per collected sample.  Both evaluate the stepsize
schedule at the absolute steps ``step0 + t`` and ship a per-step table, and
both draw one 64-bit Philox seed per call from the caller's
``torch.Generator``; the kernels key their streams on (chain, absolute step),
so no launch-length bound or re-seeding is needed.

``noise_impl``: ``'auto'`` and ``'box_muller'`` are the Philox Box-Muller
stream; ``'zero'`` is the degenerate stream (zero noise, window 0 every
step) that reproduces the JAX kernels' interpret-mode stream for parity
tests; ``'hadamard_clt'`` is not ported yet.
"""

import torch

from pysgmcmc_tpu_torch.ops.fused_step import (
    data_windows,
    fused_bnn_multistep,
    fused_bnn_multistep_burnin,
    fused_layout,
    pack,
    unpack,
)
from pysgmcmc_tpu_torch.samplers._adaptive import AdaptiveStats
from pysgmcmc_tpu_torch.samplers.sghmc import SGHMCSampler, SGHMCState


def resolve_noise_impl(noise_impl):
    """``'auto'`` -> ``'box_muller'`` (the port's only in-kernel generator);
    ``'zero'`` and ``'box_muller'`` pass through; others raise."""
    if noise_impl in ("auto", "box_muller"):
        return "box_muller"
    if noise_impl == "zero":
        return noise_impl
    if noise_impl == "hadamard_clt":
        raise NotImplementedError(
            "noise_impl='hadamard_clt' (the MXU-CLT generator) is not ported "
            "yet (ROADMAP.md queue A item 6)")
    raise ValueError(
        "noise_impl must be 'auto', 'box_muller', 'hadamard_clt' or 'zero'; "
        "got {!r}".format(noise_impl))


def _check_driver(name, sampler, mesh, pair_dots):
    if not isinstance(sampler, SGHMCSampler):
        raise NotImplementedError(
            "{}: only SGHMC is ported; {} is ROADMAP.md queue A item 9".format(
                name, type(sampler).__name__))
    if mesh is not None:
        raise NotImplementedError(
            "{}: mesh sharding is not ported yet (ROADMAP.md queue A item "
            "15)".format(name))
    if pair_dots:
        raise NotImplementedError(
            "{}: pair_dots is not ported yet (ROADMAP.md queue B, "
            "B-pair)".format(name))


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
    """``(noise, widx)`` test inputs for ``noise_impl='zero'``, else Nones."""
    if noise_impl != "zero":
        return None, None
    return (torch.zeros((k_steps, n_chains, n_params), dtype=torch.float32,
                        device=device),
            torch.zeros((k_steps, n_chains), dtype=torch.int32,
                        device=device))


def _data(x, y, batch_size, device):
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    x_win, y_win = data_windows(x, y, batch_size)
    return x_win, y_win, x.shape[0]


def burnin_chain_fused(sampler, states, key, n_steps, x, y, batch_size=20,
                       state_dtype=torch.float32, mesh=None, pair_dots=False,
                       noise_impl="auto"):
    """Run ``n_steps`` burn-in steps of every chain in one B2 launch.

    ``states`` is a stacked :class:`SGHMCState` (leaves ``(n_chains, ...)``)
    of dense-network positions, ``key`` a ``torch.Generator`` on the states'
    device, ``x``/``y`` the raw training data.  Returns the advanced states
    with ``stats.minv`` holding the mass-matrix inverse the final step used
    (the value the sampling phase freezes).
    """
    if int(n_steps) < 1:
        return states
    name = "burnin_chain_fused"
    _check_driver(name, sampler, mesh, pair_dots)
    noise_impl = resolve_noise_impl(noise_impl)
    layout = fused_layout(states.position)
    theta = pack(states.position, layout)
    device = theta.device
    x_win, y_win, n_data = _data(x, y, batch_size, device)
    step0 = int(torch.max(states.step))
    n_steps = int(n_steps)
    noise, widx = _stream_inputs(noise_impl, n_steps, theta.shape[0],
                                 layout.n_params, device)
    theta, v, tau, g, v_hat, minv, _ = fused_bnn_multistep_burnin(
        theta, pack(states.momentum, layout),
        pack(states.stats.tau, layout), pack(states.stats.g, layout),
        pack(states.stats.v_hat, layout), x_win, y_win,
        _eps_table(sampler, states.schedule_state, step0, n_steps),
        _draw_seed(key), mdecay=sampler.mdecay,
        scale_grad=sampler.scale_grad,
        prior_scale=sampler.gaussian_prior_scale, batch_size=batch_size,
        n_data=n_data, state_dtype=state_dtype, k_steps=n_steps,
        h=layout.hidden, step0=step0, noise=noise, widx=widx)
    return SGHMCState(
        position=unpack(theta, layout),
        momentum=unpack(v, layout),
        stats=AdaptiveStats(
            tau=unpack(tau, layout), g=unpack(g, layout),
            v_hat=unpack(v_hat, layout), minv=unpack(minv, layout)),
        step=states.step + n_steps,
        schedule_state=states.schedule_state,
    )


def sample_chain_fused(sampler, states, key, n_samples, x, y, batch_size=20,
                       keep_every=1, state_dtype=torch.float32,
                       collect_positions=True, mesh=None, multistep=False,
                       pair_dots=False, noise_impl="auto"):
    """Sampling-phase driver: ``n_samples`` launches of B1, each advancing
    every chain ``keep_every`` steps with the frozen ``stats.minv``.

    Returns ``(states, positions, costs)``: ``positions`` stacks the
    position after each launch as leaves ``(n_chains, n_samples, ...)``
    (``None`` without ``collect_positions``), ``costs`` is
    ``(n_chains, n_samples)``, each launch's final-step cost.  Only the
    multi-step kernel is ported: ``multistep=False`` raises.
    """
    name = "sample_chain_fused"
    if not multistep:
        raise NotImplementedError(
            "{}: the per-step kernel (multistep=False, kernel B3) is not "
            "ported yet (ROADMAP.md queue A item 6)".format(name))
    _check_driver(name, sampler, mesh, pair_dots)
    noise_impl = resolve_noise_impl(noise_impl)
    layout = fused_layout(states.position)
    theta = pack(states.position, layout)
    v = pack(states.momentum, layout)
    minv = pack(states.stats.minv, layout)
    device = theta.device
    x_win, y_win, n_data = _data(x, y, batch_size, device)
    seed = _draw_seed(key)
    step = int(torch.max(states.step))
    positions, costs = [], []
    for _ in range(int(n_samples)):
        noise, widx = _stream_inputs(noise_impl, keep_every, theta.shape[0],
                                     layout.n_params, device)
        theta, v, cost = fused_bnn_multistep(
            theta, v, minv, x_win, y_win,
            _eps_table(sampler, states.schedule_state, step, keep_every),
            seed, mdecay=sampler.mdecay, scale_grad=sampler.scale_grad,
            prior_scale=sampler.gaussian_prior_scale, batch_size=batch_size,
            n_data=n_data, state_dtype=state_dtype, k_steps=keep_every,
            h=layout.hidden, step0=step, noise=noise, widx=widx)
        step += keep_every
        if collect_positions:
            positions.append(unpack(theta, layout))
        costs.append(cost[:, 0])
    new_states = SGHMCState(
        position=unpack(theta, layout),
        momentum=unpack(v, layout),
        stats=states.stats,
        step=states.step + int(n_samples) * keep_every,
        schedule_state=states.schedule_state,
    )
    if collect_positions:
        positions = {name: torch.stack([p[name] for p in positions], dim=1)
                     for name in positions[0]}
    else:
        positions = None
    return new_states, positions, torch.stack(costs, dim=1)
