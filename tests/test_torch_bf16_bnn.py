"""The BNN's mixed precision in the port against the JAX package:
``BayesianNeuralNetwork(compute_dtype=bfloat16)`` on the fused path against
JAX's, the lanes path's bf16 cost and gradient against JAX's BNN's, a short
lanes training under ``compute_dtype``, and ``predict(compute_dtype=)``
against JAX's serving path.  Inputs are made with numpy seeds and handed to
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.models.architectures import default_network as jax_default
from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork as JaxBNN,
)
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.models import (
    BayesianNeuralNetwork,
    default_network,
    dense_network,
)
from pysgmcmc_tpu_torch.sampling import Sampler
from tests.test_torch_bnn import (
    MEAN_ATOL,
    SAMPLES_ATOL,
    SLICE,
    VAR_ATOL,
    _data,
    _jax_initial_positions,
)
from tests.test_torch_fused_step import BATCH, N_DATA

BF16 = torch.bfloat16


def _ulp(a):
    """One bf16 ulp of each value (2**-7 of its binade; 0 at 0)."""
    a = np.abs(np.asarray(a, np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-38)))
                                   - 7), 0.0)


# The f32 slice's bounds (tests/test_torch_bnn.py) hold under
# compute_dtype: measured, samples 4.9e-3 (w4), predictive mean 6.2e-4,
# variance 1.8e-4 (f32: 4.7e-3, 7.1e-4, 1.8e-4).
BNN_BF16_TOL = dict(samples=SAMPLES_ATOL, mean=MEAN_ATOL, var=VAR_ATOL)


def test_bnn_compute_dtype_matches_jax_on_the_fused_path():
    """``BayesianNeuralNetwork(compute_dtype=bfloat16)`` with SGHMC on the
    fused path against JAX's, from the same initial weights on the
    degenerate stream: f32 burn-in (B2), then sampling on B1 with bf16
    momentum and minv."""
    x, y = _data()
    jax_bnn = JaxBNN(compute_dtype=jnp.bfloat16, **SLICE)
    jax_bnn.train(x, y)
    port_bnn = BayesianNeuralNetwork(device="cpu", noise_impl="zero",
                                     compute_dtype=BF16, **SLICE)
    start = _jax_initial_positions(port_bnn.seed, port_bnn.n_chains)
    port_bnn._initial_positions = (
        lambda init_fn, generator, n: interop.params_from_numpy(start,
                                                                "cpu"))
    port_bnn.train(x, y)
    for key, leaf in jax_bnn.samples.items():
        np.testing.assert_allclose(
            port_bnn.samples[key].numpy(), np.asarray(leaf), rtol=0,
            atol=BNN_BF16_TOL["samples"],
            err_msg=key)
    grid = np.linspace(0.0, 1.0, 20)[:, None]
    for got, want, name in zip(port_bnn.predict(grid), jax_bnn.predict(grid),
                               ("mean", "var")):
        np.testing.assert_allclose(got, want, rtol=0, atol=BNN_BF16_TOL[name])


# one bf16 network pass of the same weights and batch on both sides: the
# cost within f32 rounding, the bf16 gradient within one bf16 ulp of each
# value (an f32 sum straddling a rounding boundary)
COST_RTOL = 1e-5


@pytest.mark.parametrize("network", ["reference", "dense"])
def test_lanes_bnn_compute_dtype_cost_matches_jax(network):
    """The lanes BNN's cost under ``compute_dtype=bfloat16`` (its
    ``negative_log_likelihood`` on bf16 leaves, the weight prior included),
    value and autograd gradient, against JAX's BNN's on the same bf16
    weights and minibatch: the pass the lanes drivers differentiate (JAX's
    BNN trains its lanes path on threefry noise on the CPU, which the port
    does not reproduce; the drivers are held above)."""
    jax_net, port_net = ((jax_dense, dense_network) if network == "dense"
                         else (jax_default, default_network))
    init, apply = jax_net(1, units=(8, 8))
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    init(jax.random.PRNGKey(6)))
    rng = np.random.RandomState(1)
    x = rng.uniform(size=(BATCH, 1)).astype(np.float32)
    y = rng.standard_normal((BATCH, 1)).astype(np.float32)
    jax_bnn = JaxBNN(compute_dtype=jnp.bfloat16, batch_size=BATCH)
    (want, _), want_grad = jax.value_and_grad(
        lambda p: jax_bnn.negative_log_likelihood(apply, p, x, y, N_DATA),
        has_aux=True)(params)
    port_bnn = BayesianNeuralNetwork(device="cpu", compute_dtype=BF16,
                                     batch_size=BATCH, step_impl="lanes")
    _, port_apply = port_net(1, units=(8, 8), device="cpu")
    got_grad, got = torch.func.grad_and_value(
        lambda p: port_bnn.negative_log_likelihood(
            port_apply, p, torch.tensor(x), torch.tensor(y), N_DATA)[0])(
        interop.params_from_numpy(params, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=COST_RTOL)
    for key, leaf in want_grad.items():
        assert got_grad[key].dtype == BF16, key
        w = np.asarray(leaf, np.float64)
        err = np.abs(got_grad[key].double().numpy() - w)
        assert np.all(err <= _ulp(w) + 1e-6 * np.abs(w).max()), key


@pytest.mark.parametrize("method", ["SGHMC", "SGNHT"])
def test_lanes_bnn_compute_dtype_trains(method):
    """The lanes BNN under ``compute_dtype=bfloat16`` trains on the Philox
    stream (burn-in, then sampling with bf16 state in the drivers) and
    hands out float32 samples and finite predictions; bf16 passes on the
    CPU are slow, so the run is short."""
    x, y = _data()
    bnn = BayesianNeuralNetwork(
        device="cpu", sampling_method=Sampler[method], network="reference",
        step_impl="lanes", compute_dtype=BF16, n_chains=2, n_nets=4,
        burn_in_steps=6, sample_steps=2, n_iters=10, log_every=None,
        units=(8, 8), stepsize_schedule=0.01 if method == "SGHMC" else 3e-4)
    assert bnn._state_dtype == BF16
    bnn.train(x, y)
    assert all(leaf.dtype == torch.float32 for leaf in bnn.samples.values())
    assert bnn.samples["w2"].shape == (4, 8, 8)
    mean, var = bnn.predict(x)
    assert np.isfinite(mean).all() and np.isfinite(var).all()


# bf16 forward passes on both sides over the same bf16 samples, each layer
# rounded to bf16: measured equal on the CPU (0.0); the bound allows f32
# noise in the unnormalisation.  Against the f32 predictions: 1.3e-3
# (predictive mean, scale 0.65).
SERVE_ATOL, SERVE_VS_F32_ATOL = 1e-5, 5e-3


@pytest.mark.parametrize("network", ["dense", "reference"])
def test_predict_compute_dtype_matches_jax_serving(network):
    """``predict(compute_dtype=bfloat16)`` of the same ensemble against
    JAX's serving path (``_serving_fn``), and against the port's own f32
    predictions within bf16's reach."""
    x, y = _data()
    kw = dict(SLICE, network=network,
              step_impl="fused" if network == "dense" else "lanes")
    jax_bnn = JaxBNN(**kw)
    jax_bnn.train(x, y)
    port_bnn = BayesianNeuralNetwork(device="cpu", **kw)
    port_bnn.train(x, y)  # sets the architecture and normalisation
    port_bnn.samples = interop.params_from_numpy(jax_bnn.samples, "cpu")
    for attr in ("x_mean", "x_std", "y_mean", "y_std"):
        setattr(port_bnn, attr, getattr(jax_bnn, attr))
    grid = np.linspace(0.0, 1.0, 33)[:, None]
    got = port_bnn.predict(grid, return_individual_predictions=True,
                           compute_dtype=BF16)
    want = jax_bnn.predict(grid, return_individual_predictions=True,
                           compute_dtype=jnp.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=SERVE_ATOL)
    f32 = port_bnn.predict(grid)
    bf = port_bnn.predict(grid, compute_dtype=BF16)
    np.testing.assert_allclose(bf[0], f32[0], rtol=0,
                               atol=SERVE_VS_F32_ATOL)
    np.testing.assert_allclose(
        jax_bnn.predict(grid, compute_dtype=jnp.bfloat16)[0], bf[0],
        rtol=0, atol=SERVE_ATOL)




# what changes after training: (attribute, its new value given the trained
# network and the other built-in one)
_CHANGES = {
    "network": lambda trained, other: other,
    "units": lambda trained, other: (13, 13),
    "get_net": lambda trained, other: (
        default_network if other == "reference" else dense_network)(
            1, units=(13, 13), device="cpu"),
}


@pytest.mark.parametrize("change", sorted(_CHANGES))
@pytest.mark.parametrize("trained,other", [("dense", "reference"),
                                           ("reference", "dense")])
def test_predict_compute_dtype_serves_the_trained_network(change, trained,
                                                          other):
    """``predict(compute_dtype=bfloat16)`` serves the network ``train``
    fixed, whatever ``network``, ``units`` or ``get_net`` say afterwards
    (ROADMAP C7; the JAX package rebuilds from them at call time, so the
    oracle is the bf16 predict taken before the change): equal bit for bit,
    and the f32 predict unchanged."""
    x, y = _data()
    bnn = BayesianNeuralNetwork(
        device="cpu", network=trained, step_impl="lanes", n_chains=2,
        n_nets=4, burn_in_steps=4, sample_steps=2, n_iters=8,
        log_every=None, units=(8, 8))
    bnn.train(x, y)
    grid = np.linspace(0.0, 1.0, 9)[:, None]
    before = (bnn.predict(grid, compute_dtype=BF16), bnn.predict(grid))
    setattr(bnn, change, _CHANGES[change](trained, other))
    after = (bnn.predict(grid, compute_dtype=BF16), bnn.predict(grid))
    for got, want in zip(after, before):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_predict_compute_dtype_refuses_a_custom_network():
    """A network trained through ``get_net`` has no built-in builder to
    serve at another precision: ``predict(compute_dtype=...)`` raises."""
    x, y = _data()
    bnn = BayesianNeuralNetwork(
        device="cpu", step_impl="lanes", n_chains=2, n_nets=4,
        burn_in_steps=4, sample_steps=2, n_iters=8, log_every=None,
        get_net=default_network(1, units=(8, 8), device="cpu"))
    bnn.train(x, y)
    grid = np.linspace(0.0, 1.0, 9)[:, None]
    assert np.isfinite(bnn.predict(grid)[0]).all()
    with pytest.raises(ValueError, match="built-in"):
        bnn.predict(grid, compute_dtype=BF16)
