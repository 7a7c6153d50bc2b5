"""The work of one predictive query batch: the forward pass of every
member at every point, and the members' mean and variance at each point,
counted from the algorithm.

Products: :func:`perfbench.work.network.forward_products` per member.
Float32: the forward's elementwise operations and the mean and variance
(3 a member-point).  Bytes: the members' parameters and the points read
once, the mean and variance written once.
"""

from perfbench.reference.stream import n_params
from perfbench.work import network


def work(shape, n_members, n_points):
    return dict(
        tc_flops=n_members * network.forward_products(shape, n_points),
        f32_flops=n_members * (network.forward_elementwise(shape, n_points)
                               + 3 * n_points),
        bytes=4 * (n_members * n_params(*shape) + n_points * shape[0]
                   + 2 * n_points))
