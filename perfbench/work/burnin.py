"""The work of one call of the SGHMC self-tuning burn-in over ``n_chains``
chains for ``n_steps`` steps, counted from the algorithm.

Per chain-step: the network's cost and gradient on a minibatch
(:mod:`perfbench.work.network`); per parameter the weight prior (2), the
mass's root and guarded inverse (5), the statistics tau (9), g (4) and
v_hat (5), the noise scale (4), the momentum (7) and the position (1), and
one standard normal, counted as :data:`NORMAL_OPS`.  Bytes: each chain's
state read once (theta, v, tau, g, v_hat) and written once (the same and
minv), the data and the stepsize table, per call.
"""

from perfbench.reference.stream import n_params
from perfbench.work import network

NORMAL_OPS = 1
RULE_OPS = 2 + 5 + 9 + 4 + 5 + 4 + 7 + 1


def work(shape, batch, n_data, n_chains, n_steps):
    p = n_params(*shape)
    chain_steps = n_chains * n_steps
    return dict(
        tc_flops=chain_steps * network.gradient_products(shape, batch),
        f32_flops=chain_steps * (network.gradient_elementwise(shape, batch)
                                 + p * (RULE_OPS + NORMAL_OPS)),
        bytes=4 * (n_chains * p * 11 + n_data * (shape[0] + 1)
                   + 2 * n_steps))
