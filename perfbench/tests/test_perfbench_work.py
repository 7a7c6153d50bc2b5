"""The work counts of perfbench/work against hand counts for a small
layout: one input, two hidden layers of 2, batch 3 (14 parameters)."""

import os

from perfbench import roofline
from perfbench.reference.stream import n_params
from perfbench.work import burnin, network, predict, sampling, transport

SHAPE = (1, 2, 2)


def test_network_products_by_hand():
    # forward 3 x (1x2 + 2x2 + 2x1) = 24 multiply-adds, the weight
    # gradients 24 more, the input gradients of the second layer and the
    # head 3 x (2x2 + 2x1) = 18: 66 multiply-adds
    assert network.gradient_products(SHAPE, 3) == 132
    assert network.forward_products(SHAPE, 5) == 80
    # 12 hidden activations: bias and tanh (24), tanh' and the bias sums
    # (48); per point the head's bias, the loss and its gradients
    # (3 + 18 + 21); per chain 8
    assert network.gradient_elementwise(SHAPE, 3) == 122
    # 20 hidden activations at 5 points: bias and tanh; the head's bias
    assert network.forward_elementwise(SHAPE, 5) == 45


def test_rules_and_roles_by_hand():
    assert n_params(*SHAPE) == 14
    w = burnin.work(SHAPE, 3, 7, n_chains=4, n_steps=5)
    assert w == dict(tc_flops=20 * 132, f32_flops=20 * (122 + 14 * 38),
                     bytes=4 * (4 * 14 * 11 + 7 * 2 + 2 * 5))
    w = sampling.work(SHAPE, 3, 7, n_chains=4, n_keep=2, keep_every=3)
    assert w == dict(tc_flops=24 * 132,
                     f32_flops=24 * (122 + 14 * 11) + 4 * 14 * 4,
                     bytes=4 * (4 * (14 * 7 + 2) + 7 * 2 + 2 * 6))
    assert transport.work(3, 4) == dict(tc_flops=216, f32_flops=114,
                                        bytes=144)
    assert predict.work(SHAPE, 3, 5) == dict(tc_flops=240, f32_flops=180,
                                             bytes=228)


def test_flagship_counts():
    # the 3x50 network: 610,000 product operations a chain-step at batch 20
    assert network.gradient_products((1, 50, 3), 20) == 610000
    assert n_params(1, 50, 3) == 5252


def test_least_time_is_the_slowest_pipe():
    peak = dict(tf32_flops=10.0, f32_flops=2.0, hbm_bytes_per_s=4.0)
    assert roofline.least_seconds(
        dict(tc_flops=10, f32_flops=1, bytes=1), peak) == 1.0
    assert roofline.least_seconds(
        dict(tc_flops=1, f32_flops=8, bytes=1), peak) == 4.0
    assert roofline.least_seconds(
        dict(tc_flops=1, f32_flops=1, bytes=20), peak) == 5.0


def test_counts_describe_the_algorithm_not_an_implementation():
    folder = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "work")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                text = f.read().lower()
            for word in ("3xtf32", "tf32 pass", "philox", "box", "hadamard",
                         "clt", "noise_ops"):
                assert word not in text, (name, word)
