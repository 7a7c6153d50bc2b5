"""The plain reference of perfbench/reference against the port's CPU path
at a tiny size.  Only this test imports both: the reference imports
nothing of the port."""

import ast
import os

import pytest
import torch

from perfbench.reference import bnn as ref_bnn
from perfbench.reference import init as ref_init
from perfbench.reference import sghmc as ref_sghmc
from perfbench.reference import stream as ref_stream
from pysgmcmc_tpu_torch.models.architectures import (
    default_network,
    dense_network,
)
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.ops.pairwise import svgd_kernel

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")
SEED = 2**31 + 77


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(REFERENCE):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert set(tops) <= {"math", "torch", "perfbench"}, (name, tops)


@pytest.mark.parametrize("hidden,depth", [(50, 3), (8, 2), (60, 4)])
def test_stream_matches_the_port(hidden, depth):
    layout = fs.FusedLayout(2, hidden, depth)
    chains = torch.tensor([0, 3, 7])
    got = ref_stream.clt_normals(SEED, torch.tensor([5, 9]), chains, 2,
                                 hidden, depth)
    for t, step in enumerate((5, 9)):
        want = fs.clt_normals(SEED, step, 8, layout, "cpu")[chains]
        assert torch.equal(got[t], want)
    windows = ref_stream.windows(SEED, torch.tensor([4]), chains, 81)[0]
    assert torch.equal(windows, fs.philox_windows(SEED, 4, 8, 81,
                                                  "cpu")[chains])
    assert ref_stream.n_params(2, hidden, depth) == layout.n_params


def test_initial_weights_match_the_port():
    init, _ = dense_network(1, (50, 50, 50), device="cpu")
    params = init(torch.Generator().manual_seed(SEED), (3,))
    flat = fs.pack(params, fs.fused_layout(params))
    assert torch.equal(ref_init.initial_weights(SEED, 3, 1, 50, 3, "cpu"),
                       flat)


def _setup(n=4, hidden=50, depth=3):
    layout = fs.FusedLayout(1, hidden, depth)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(30, 1, generator=gen)
    y = torch.sin(6 * x[:, 0])
    theta = 0.3 * torch.randn(n, layout.n_params, generator=gen)
    x_win, y_win = fs.data_windows(x, y, 8)
    return layout, theta, x, y, x_win, y_win


@pytest.mark.parametrize("burn_in", [True, False])
def test_sghmc_matches_the_port(burn_in):
    layout, theta, x, y, x_win, y_win = _setup()
    n, p = theta.shape
    gen = torch.Generator().manual_seed(4)
    v = 0.01 * torch.randn(n, p, generator=gen)
    g = 0.1 * torch.randn(n, p, generator=gen)
    stats = [1.0 + torch.rand(n, p, generator=gen), g,
             g * g + torch.rand(n, p, generator=gen)]
    common = dict(mdecay=0.05, scale_grad=30.0, prior_scale=1e-3,
                  batch_size=8, n_data=30, k_steps=6, h=50,
                  noise_impl="hadamard_clt", step0=11)
    rule = dict(eps=0.01, scale_grad=30.0, mdecay=0.05, prior_scale=1e-3,
                n_data=30, burn_in=burn_in)
    rx, ry = ref_sghmc.data_windows(x, y, 8)
    chains = torch.arange(n)
    if burn_in:
        want = fs.fused_bnn_multistep_burnin_ref(
            theta, v, *stats, x_win, y_win, 0.01, SEED, **common)
        state = dict(theta=theta, v=v, tau=stats[0], g=stats[1],
                     v_hat=stats[2])
        got, cost, _ = ref_sghmc.follow(state, chains, SEED, 11, 6, rx, ry,
                                        rule, (1, 50, 3))
        names = ("theta", "v", "tau", "g", "v_hat", "minv")
    else:
        minv = stats[2]
        want = fs.fused_bnn_multistep_ref(theta, v, minv, x_win, y_win,
                                          0.01, SEED, **common)
        got, cost, _ = ref_sghmc.follow(dict(theta=theta, v=v, minv=minv),
                                        chains, SEED, 11, 6, rx, ry, rule,
                                        (1, 50, 3))
        names = ("theta", "v")
    for name, value in zip(names, want):
        assert torch.allclose(got[name], value, rtol=1e-5, atol=1e-7), name
    assert torch.allclose(cost, want[-1], rtol=1e-5)


def test_svgd_phi_matches_the_port():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, 9, generator=gen)
    grads = torch.randn(16, 9, generator=gen)
    kernel, grad_kernel = svgd_kernel(x)
    want = (torch.matmul(kernel, -grads) + grad_kernel) / 16
    assert torch.allclose(ref_bnn.svgd_phi(x, grads), want, rtol=1e-5,
                          atol=1e-6)


def test_network_gradient_matches_autograd():
    _, apply = default_network(1, (8, 8), device="cpu")
    init, _ = default_network(1, (8, 8), device="cpu")
    params = init(torch.Generator().manual_seed(6), (3,))
    flat = torch.cat([leaf.reshape(3, -1) for leaf in params.values()], 1)
    xb = torch.rand(3, 5, 1)
    yb = torch.rand(3, 5)

    def cost(flat_row, x, y):
        p = ref_bnn.unflatten(flat_row[None], 1, 8, 2)
        net = {k: v[0] for k, v in p.items()}
        net["w3"] = net["w3"][:, None]
        net["log_variance_bias"] = net["log_variance_bias"].reshape(1, 1)
        out = apply(net, x)
        mean, log_var = out[:, 0], out[:, 1]
        ll = torch.sum(-(mean - y) ** 2 * 0.5 / (torch.exp(log_var) + 1e-16)
                       - 0.5 * log_var) / 5
        dev = log_var[0] - ref_bnn.LOG_PRIOR_MEAN
        prior = -dev * dev / (2 * ref_bnn.PRIOR_VAR) \
            - 0.5 * torch.log(torch.tensor(ref_bnn.PRIOR_VAR))
        return -(ll + prior / 30)

    want = torch.stack([torch.func.grad(cost)(flat[i], xb[i], yb[i])
                        for i in range(3)])
    _, got = ref_bnn.cost_and_grad(flat, xb, yb, (1, 8, 2), 1 / 5, 1 / 30)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-6)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10),
                      1.0 + 2**-12])
    assert ref_bnn.tf32(x).tolist() == [1.0, 1.0 + 2**-9, -(1.0 + 2**-10),
                                        1.0]
