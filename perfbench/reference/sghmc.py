"""SGHMC with the self-tuning burn-in of Springenberg et al. 2016, over a
block of chains, in plain PyTorch and float32.

Each step: every chain takes its own minibatch window and its own normals
(:mod:`perfbench.reference.stream`, keyed by the chain's index in the whole
ensemble), computes its cost and gradient (:mod:`perfbench.reference.bnn`),
adds the weight prior's ``prior_scale * theta``, and updates

    v' = v - eps^2 minv g - mdecay v + sqrt(max(2 es^2 mdecay minv - es^4,
         1e-16)) eta,   theta' = theta + v',   es = eps / sqrt(scale_grad);

in burn-in ``minv = 1 / sqrt(v_hat)`` from the statistics before the step,
which then adapt (:func:`perfbench.reference.bnn.adapt`); in sampling
``minv`` is the one burn-in ended with.
"""

import torch

from perfbench.reference import bnn, stream


def data_windows(x, y, batch_size):
    """``x_win[w, b] = x[w + b]`` ``(n_windows, B, n_inputs)``, and ``y``'s."""
    n = x.shape[0]
    idx = (torch.arange(n - batch_size + 1, device=x.device)[:, None]
           + torch.arange(batch_size, device=x.device)[None, :])
    return x[idx], y.reshape(-1)[idx]


def follow(state, chains, seed, step0, n_steps, x_win, y_win, rule, shape,
           precision="float32", keep_every=None, chunk=64):
    """Advance ``state`` (float32 ``(len(chains), P)`` arrays: ``theta``,
    ``v`` and, in burn-in, ``tau``, ``g``, ``v_hat``; in sampling ``minv``)
    by ``n_steps`` steps from absolute step ``step0`` on the stream of
    ``seed``.  ``rule`` holds ``eps``, ``scale_grad``, ``mdecay``,
    ``prior_scale``, ``n_data`` and ``burn_in``.  Returns ``(state, cost,
    kept)``: burn-in's state gains the ``minv`` its last step used;
    ``cost`` ``(n, 1)`` is the last step's; ``kept`` the ``(theta, cost)``
    after every ``keep_every`` steps."""
    state = dict(state)
    device = state["theta"].device
    eps = torch.tensor(rule["eps"], dtype=torch.float32, device=device)
    inv_b = torch.tensor(1.0 / x_win.shape[1], dtype=torch.float32).item()
    inv_n = torch.tensor(1.0 / rule["n_data"], dtype=torch.float32).item()
    prior_scale = torch.tensor(rule["prior_scale"],
                               dtype=torch.float32).item()
    burn_in = rule["burn_in"]
    sigma = None if burn_in else bnn.sghmc_noise_scale(
        eps, rule["scale_grad"], rule["mdecay"], state["minv"])
    kept, cost = [], None
    for c0 in range(0, n_steps, chunk):
        steps = torch.arange(step0 + c0, step0 + min(n_steps, c0 + chunk),
                             dtype=torch.int64, device=device)
        widx = stream.windows(seed, steps, chains, x_win.shape[0])
        noise = stream.clt_normals(seed, steps, chains, *shape)
        for t in range(len(steps)):
            theta, v = state["theta"], state["v"]
            cost, grad = bnn.cost_and_grad(
                theta, x_win[widx[t]], y_win[widx[t]], shape, inv_b, inv_n,
                precision)
            gg = grad + prior_scale * theta
            if burn_in:
                minv, state["tau"], state["g"], state["v_hat"] = bnn.adapt(
                    state["tau"], state["g"], state["v_hat"], gg)
                state["minv"] = minv
                scale = bnn.sghmc_noise_scale(
                    eps, rule["scale_grad"], rule["mdecay"], minv)
            else:
                minv, scale = state["minv"], sigma
            v = v - eps * eps * minv * gg - rule["mdecay"] * v \
                + scale * noise[t]
            if not burn_in:
                v = torch.where(minv > 0.0, v, torch.zeros_like(v))
            state["theta"], state["v"] = theta + v, v
            done = c0 + t + 1
            if keep_every and done % keep_every == 0:
                kept.append((state["theta"], cost))
    return state, cost, kept
