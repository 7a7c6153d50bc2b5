"""The port's network, likelihood and per-step SGHMC sampler against the
JAX package, on JAX-initialised weights carried across through
``pysgmcmc_tpu_torch.interop``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pysgmcmc_tpu.models.architectures import default_network as jax_default
from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork as JaxBNN,
    log_variance_prior_log_like as jax_lvp,
    weight_prior_log_like as jax_wp,
)
from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats as JaxStats
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler as JaxSGHMC
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.models import (
    BayesianNeuralNetwork,
    default_network,
    dense_network,
    log_variance_prior_log_like,
    weight_prior_log_like,
)
from pysgmcmc_tpu_torch.samplers import AdaptiveStats, SGHMCSampler

# f32 on both sides: only summation order differs (XLA vs ATen kernels).
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_params(n_inputs, units=(50, 50, 50), seed=0):
    init, apply = jax_dense(n_inputs, units=units)
    return init(jax.random.PRNGKey(seed)), apply


def _data(n_inputs, n=20, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n, n_inputs)).astype(np.float32)
    y = rng.standard_normal((n, 1)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n_inputs,units", [(1, (50, 50, 50)), (3, (8, 8))])
def test_dense_network_apply_matches_jax(n_inputs, units):
    params, apply = _jax_params(n_inputs, units)
    x, _ = _data(n_inputs)
    _, port_apply = dense_network(n_inputs, units=units, device="cpu")
    got = port_apply(interop.params_from_numpy(params, "cpu"),
                     torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(apply(params, x)),
                               **TOL)
    for key, leaf in params.items():  # the JAX shapes are kept
        port_params = dense_network(n_inputs, units=units, device="cpu")[0](
            torch.Generator().manual_seed(0))
        assert tuple(port_params[key].shape) == leaf.shape, key


@pytest.mark.parametrize("n_inputs,units", [(1, (50, 50, 50)), (3, (8, 8))])
def test_default_network_apply_matches_jax(n_inputs, units):
    init, apply = jax_default(n_inputs, units=units)
    params = init(jax.random.PRNGKey(0))
    x, _ = _data(n_inputs)
    port_init, port_apply = default_network(n_inputs, units=units,
                                            device="cpu")
    got = port_apply(interop.params_from_numpy(params, "cpu"),
                     torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(apply(params, x)),
                               **TOL)
    port_params = port_init(torch.Generator().manual_seed(0))
    assert list(port_params) == list(params)  # w1, b1, ..., log_variance_bias
    for key, leaf in params.items():  # the JAX shapes are kept
        assert tuple(port_params[key].shape) == leaf.shape, key


@pytest.mark.parametrize("n_inputs", [1, 3])
def test_default_and_dense_networks_share_init_draws(n_inputs):
    """As in JAX, one generator gives both networks the same weights (the
    dense network squeezes the reference shapes) and the same outputs."""
    units = (6, 6, 6)
    ref = default_network(n_inputs, units=units, device="cpu")
    dense = dense_network(n_inputs, units=units, device="cpu")
    p_ref = ref[0](torch.Generator().manual_seed(3), (2,))
    p_dense = dense[0](torch.Generator().manual_seed(3), (2,))
    assert list(p_ref) == list(p_dense)
    for key, leaf in p_ref.items():
        assert torch.equal(leaf.reshape(p_dense[key].shape), p_dense[key]), key
    x = torch.tensor(_data(n_inputs)[0])
    torch.testing.assert_close(ref[1](p_ref, x), dense[1](p_dense, x),
                               rtol=1e-6, atol=1e-6)
    jax_ref, jax_dense_pair = jax_default(n_inputs, units), jax_dense(
        n_inputs, units)
    key = jax.random.PRNGKey(5)
    for k, leaf in jax_ref[0](key).items():
        assert leaf.reshape(jax_dense_pair[0](key)[k].shape).shape == \
            tuple(p_dense[k].shape[1:]), k


def test_nll_and_gradients_match_jax():
    params, apply = _jax_params(1)
    x, y = _data(1)
    jax_bnn = JaxBNN(network="dense", step_impl="fused")
    port_bnn = BayesianNeuralNetwork(network="dense", step_impl="fused",
                                     device="cpu")
    (nll, mse), grads = jax.value_and_grad(
        lambda p: jax_bnn.negative_log_likelihood(apply, p, x, y, 100),
        has_aux=True)(params)

    _, port_apply = dense_network(1, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in
              interop.params_from_numpy(params, "cpu").items()}
    port_nll, port_mse = port_bnn.negative_log_likelihood(
        port_apply, leaves, torch.tensor(x), torch.tensor(y), 100)
    port_grads = torch.autograd.grad(port_nll, list(leaves.values()))
    np.testing.assert_allclose(float(port_nll.detach()), float(nll), rtol=1e-5)
    np.testing.assert_allclose(float(port_mse), float(mse), rtol=1e-5)
    for key, g in zip(leaves, port_grads):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(grads[key]), rtol=1e-4,
            atol=1e-6 * float(np.abs(np.asarray(grads[key])).max()),
            err_msg=key)


def test_priors_match_jax():
    params, _ = _jax_params(1)
    port = interop.params_from_numpy(params, "cpu")
    np.testing.assert_allclose(float(weight_prior_log_like(port)),
                               float(jax_wp(params)), rtol=1e-6)
    lv = np.linspace(-14.0, 2.0, 12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_allclose(
        float(log_variance_prior_log_like(torch.tensor(lv))),
        float(jax_lvp(jnp.asarray(lv))), rtol=1e-6)


def _fused_cost(apply, lvp, xp):
    """The fused path's cost: likelihood + log-variance prior (the weight
    prior is folded in through gaussian_prior_scale)."""
    def cost(params, batch):
        xb, yb = batch
        out = apply(params, xb)
        f_mean, f_log_var = out[:, 0:1], out[:, 1:2]
        mse = (yb - f_mean) ** 2
        ll = xp.sum(-mse * (0.5 / (xp.exp(f_log_var) + 1e-16))
                    - 0.5 * f_log_var) / 20.0
        return -(ll + lvp(f_log_var) / 100.0)
    return cost


@pytest.mark.parametrize("phase", ["burn_in", "sampling", None])
def test_sghmc_step_matches_jax(phase):
    """Two SGHMC steps with injected noise, f32 on both sides
    (rtol 1e-4, atol 1e-5: summation order only, carried two steps)."""
    params, apply = _jax_params(1)
    x, y = _data(1)
    rng = np.random.RandomState(4)

    def like(lo, hi):
        return {k: rng.uniform(lo, hi, np.shape(v)).astype(np.float32)
                for k, v in params.items()}

    stats = dict(tau=like(1.0, 5.0), g=like(-1.0, 1.0),
                 v_hat=like(1.0, 5.0), minv=like(0.2, 1.2))
    momentum = like(-1e-3, 1e-3)
    noises = [like(-2.0, 2.0) for _ in range(2)]
    kwargs = dict(stepsize_schedule=0.01, burn_in_steps=1, mdecay=0.05,
                  scale_grad=100.0, gaussian_prior_scale=1e-4)

    jax_sampler = JaxSGHMC(_fused_cost(apply, jax_lvp, jnp), **kwargs)
    state = jax_sampler.init(params)._replace(
        momentum=momentum, stats=JaxStats(**stats))
    for eta in noises:
        state = jax_sampler.step(state, jax.random.PRNGKey(0), (x, y),
                                 noise=eta, phase=phase)[0]

    _, port_apply = dense_network(1, device="cpu")
    port_sampler = SGHMCSampler(
        _fused_cost(port_apply, log_variance_prior_log_like, torch), **kwargs)
    port_state = port_sampler.init(interop.params_from_numpy(params, "cpu"))
    port_state = port_state._replace(
        momentum=interop.params_from_numpy(momentum, "cpu"),
        stats=AdaptiveStats(**{k: interop.params_from_numpy(v, "cpu")
                               for k, v in stats.items()}))
    batch = (torch.tensor(x), torch.tensor(y))
    for eta in noises:
        port_state, info = port_sampler.step(
            port_state, None, batch,
            noise=interop.params_from_numpy(eta, "cpu"), phase=phase)
    assert int(port_state.step) == int(state.step) == 2
    got = interop.state_to_numpy(port_state)
    for field, want in (("position", state.position),
                        ("momentum", state.momentum),
                        ("tau", state.stats.tau), ("g", state.stats.g),
                        ("v_hat", state.stats.v_hat),
                        ("minv", state.stats.minv)):
        for key in want:
            np.testing.assert_allclose(
                got[field][key], np.asarray(want[key]), rtol=1e-4,
                atol=1e-5, err_msg="{} {} {}".format(phase, field, key))


def test_sghmc_step_draws_from_the_generator():
    sampler = SGHMCSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
                           stepsize_schedule=0.1)
    state = sampler.init({"x": torch.zeros(3)})
    a = sampler.step(state, torch.Generator().manual_seed(1))[0]
    b = sampler.step(state, torch.Generator().manual_seed(1))[0]
    c = sampler.step(state, torch.Generator().manual_seed(2))[0]
    assert torch.equal(a.position["x"], b.position["x"])
    assert not torch.equal(a.position["x"], c.position["x"])


def test_init_distribution():
    """He-normal truncated at 2 sigma, sigma = sqrt(1/fan_in)/0.8796...;
    the streams differ from JAX's, so the distribution is tested (KS)."""
    init, _ = dense_network(1, device="cpu")
    params = init(torch.Generator().manual_seed(0), (64,))
    std = math.sqrt(1.0 / 50) / 0.87962566103423978
    w = params["w2"].numpy().ravel() / std
    assert np.abs(w).max() <= 2.0
    assert scipy.stats.kstest(w, scipy.stats.truncnorm(-2, 2).cdf).pvalue > 1e-3
    np.testing.assert_allclose(params["w2"].numpy().std(),
                               math.sqrt(1.0 / 50), rtol=0.02)
    w1 = params["w1"].numpy().ravel() / (1.0 / 0.87962566103423978)
    assert scipy.stats.kstest(w1, scipy.stats.truncnorm(-2, 2).cdf).pvalue > 1e-3
    for i in range(1, 5):
        assert not params["b{}".format(i)].any()
    assert torch.all(params["log_variance_bias"] == math.log(1e-3))
    jax_params, _ = _jax_params(1)
    for key, leaf in jax_params.items():
        assert tuple(params[key].shape[1:]) == leaf.shape, key
        assert params[key].dtype == torch.float32
