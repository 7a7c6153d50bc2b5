"""The work of one call of SGHMC sampling with a frozen mass over
``n_chains`` chains, ``n_keep`` kept positions ``keep_every`` steps apart,
counted from the algorithm.

Per chain-step: the network's cost and gradient on a minibatch
(:mod:`perfbench.work.network`); per parameter the weight prior (2), the
momentum (7) and the position (1), and one standard normal, counted as
:data:`NORMAL_OPS`; the noise scale (4 a parameter) once per call, the mass
being frozen.  Bytes: each chain's theta, v and minv read once, theta and v
written once, each kept position and cost written, the data and the
stepsize table, per call.
"""

from perfbench.reference.stream import n_params
from perfbench.work import network

NORMAL_OPS = 1
RULE_OPS = 2 + 7 + 1


def work(shape, batch, n_data, n_chains, n_keep, keep_every):
    p = n_params(*shape)
    n_steps = n_keep * keep_every
    chain_steps = n_chains * n_steps
    return dict(
        tc_flops=chain_steps * network.gradient_products(shape, batch),
        f32_flops=(chain_steps * (network.gradient_elementwise(shape, batch)
                                  + p * (RULE_OPS + NORMAL_OPS))
                   + n_chains * p * 4),
        bytes=4 * (n_chains * (p * (5 + n_keep) + n_keep)
                   + n_data * (shape[0] + 1) + 2 * n_steps))
