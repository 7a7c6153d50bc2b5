"""The slice as a whole: the port's fused ``BayesianNeuralNetwork`` (train
then predict) against the JAX package's, and its validation against JAX's.

JAX runs its Pallas kernels in interpret mode on the CPU, whose zero-bit
PRNG gives zero noise and window 0 every step; the port runs its kernels'
plain versions on the degenerate stream that reproduces this
(``noise_impl="zero"``), from the same initial weights (carried across
with ``pysgmcmc_tpu_torch.interop``).
"""

import inspect
import logging

import jax
import numpy as np
import pytest
import torch

from pysgmcmc_tpu import sampling as jax_sampling
from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork as JaxBNN,
)
from pysgmcmc_tpu.parallel import packed as jax_packed
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, dense_network
from pysgmcmc_tpu_torch.ops import _build
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_fused,
    burnin_chain_lanes,
    sample_chain_fused,
    sample_chain_lanes,
)
from pysgmcmc_tpu_torch.samplers import SGHMCSampler
from pysgmcmc_tpu_torch.sampling import Sampler

SLICE = dict(network="dense", step_impl="fused", n_chains=2, n_nets=4,
             burn_in_steps=8, sample_steps=4, n_iters=16, log_every=None)
# Measured deviation of the port from JAX on this slice (f32 port vs the
# TPU kernel's bf16 MXU operands, 16 steps): samples 4.7e-3 (w4), predictive
# mean 7.1e-4, variance 1.8e-4.  The bounds are about twice that.
SAMPLES_ATOL, MEAN_ATOL, VAR_ATOL = 1e-2, 2e-3, 5e-4
# The same for SGLD (B6 burn-in, B5-sgld sampling), measured: samples 1.8e-2
# (w4, at scale 4.0), predictive mean 3.2e-2, variance 3.5e-2 (scale 2.0),
# one member's mean 7.0e-2, noise 0.6 % relative.  SGLD moves theta by
# eps * minv * g (SGHMC: eps**2 * minv * g) from the same unadapted start,
# so the weights move 100x further and carry the TPU kernel's bf16 rounding
# with them (about 0.4 % of their scale).  The bounds are about twice that.
SGLD_SAMPLES_ATOL, SGLD_MEAN_ATOL, SGLD_VAR_ATOL = 4e-2, 7e-2, 7e-2
SGLD_MEMBER_ATOL, SGLD_NOISE_RTOL = 0.15, 1.5e-2


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    return x, np.sinc(x[:, 0] * 10 - 5)


def _jax_initial_positions(seed, n_chains):
    """The weights JAX's _train_fused draws: vmap(init)(split(key_net))."""
    key_net = jax.random.split(jax.random.PRNGKey(seed), 4)[0]
    init, _ = jax_dense(1)
    return jax.vmap(init)(jax.random.split(key_net, n_chains))


def _port_bnn(**kwargs):
    """The port's BNN on the degenerate stream, starting from JAX's
    initial weights (test hook: ``_initial_positions``)."""
    bnn = BayesianNeuralNetwork(device="cpu", noise_impl="zero", **kwargs)
    positions = _jax_initial_positions(bnn.seed, bnn.n_chains)
    bnn._initial_positions = (
        lambda init_fn, generator, n: interop.params_from_numpy(
            positions, "cpu"))
    return bnn


@pytest.fixture(scope="module")
def trained():
    x, y = _data()
    jax_bnn = JaxBNN(**SLICE)
    jax_bnn.train(x, y)
    port_bnn = _port_bnn(**SLICE)
    port_bnn.train(x, y)
    return jax_bnn, port_bnn


@pytest.fixture(scope="module")
def trained_sgld():
    x, y = _data()
    jax_bnn = JaxBNN(sampling_method=jax_sampling.Sampler.SGLD, **SLICE)
    jax_bnn.train(x, y)
    port_bnn = _port_bnn(sampling_method=Sampler.SGLD, **SLICE)
    port_bnn.train(x, y)
    return jax_bnn, port_bnn


def test_samples_match_jax(trained):
    jax_bnn, port_bnn = trained
    assert set(port_bnn.samples) == set(jax_bnn.samples)
    for key, want in jax_bnn.samples.items():
        got = port_bnn.samples[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=SAMPLES_ATOL, err_msg=key)


def test_predict_matches_jax(trained):
    jax_bnn, port_bnn = trained
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    want_mean, want_var = jax_bnn.predict(x_grid)
    mean, var = port_bnn.predict(x_grid)
    assert mean.shape == want_mean.shape == (50,)
    assert var.shape == want_var.shape == (50,)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=MEAN_ATOL)
    np.testing.assert_allclose(var, want_var, rtol=0, atol=VAR_ATOL)
    f_out, noise = port_bnn.predict(x_grid, return_individual_predictions=True)
    want_f, want_noise = jax_bnn.predict(
        x_grid, return_individual_predictions=True)
    assert f_out.shape == want_f.shape == (4, 50)
    np.testing.assert_allclose(f_out, want_f, rtol=0, atol=5 * MEAN_ATOL)
    np.testing.assert_allclose(noise, want_noise, rtol=1e-2)


def test_sgld_samples_match_jax(trained_sgld):
    jax_bnn, port_bnn = trained_sgld
    assert set(port_bnn.samples) == set(jax_bnn.samples)
    for key, want in jax_bnn.samples.items():
        got = port_bnn.samples[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=SGLD_SAMPLES_ATOL, err_msg=key)


def test_sgld_predict_matches_jax(trained_sgld):
    jax_bnn, port_bnn = trained_sgld
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    want_mean, want_var = jax_bnn.predict(x_grid)
    mean, var = port_bnn.predict(x_grid)
    assert mean.shape == want_mean.shape == (50,)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=SGLD_MEAN_ATOL)
    np.testing.assert_allclose(var, want_var, rtol=0, atol=SGLD_VAR_ATOL)
    f_out, noise = port_bnn.predict(x_grid, return_individual_predictions=True)
    want_f, want_noise = jax_bnn.predict(
        x_grid, return_individual_predictions=True)
    assert f_out.shape == want_f.shape == (4, 50)
    np.testing.assert_allclose(f_out, want_f, rtol=0, atol=SGLD_MEMBER_ATOL)
    np.testing.assert_allclose(noise, want_noise, rtol=SGLD_NOISE_RTOL)


def test_network_output_and_base_model_helpers_match_jax(trained):
    """One sample's forward pass and the BaseModel helpers the port copies.
    The outputs deviate by up to 4.4e-3 (measured), carried over from the
    samples, so they take the samples' bound."""
    jax_bnn, port_bnn = trained
    x = np.linspace(-1.0, 1.0, 9)[:, None]
    for i in range(2):
        want = jax_bnn.compute_network_output(
            {k: v[i] for k, v in jax_bnn.samples.items()}, x)
        got = port_bnn.compute_network_output(
            {k: v[i] for k, v in port_bnn.samples.items()}, x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SAMPLES_ATOL)
    for name in ("get_incumbent", "get_json_data"):
        got, want = getattr(port_bnn, name)(), getattr(jax_bnn, name)()
        if name == "get_json_data":
            assert got == want
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_predict_uses_the_trained_architecture(trained):
    """The serving path captures the architecture at train time (the JAX
    package re-reads the mutable ``units``, ROADMAP C)."""
    _, port_bnn = trained
    x_grid = np.linspace(0.0, 1.0, 7)[:, None]
    before = port_bnn.predict(x_grid)
    units = port_bnn.units
    port_bnn.units = (13, 13)
    try:
        after = port_bnn.predict(x_grid)
    finally:
        port_bnn.units = units
    np.testing.assert_array_equal(before[0], after[0])


def test_log_every_segments_match_one_segment(caplog):
    """Burn-in chunked at log boundaries and one launch per collected
    sample give the same chains as one segment (the stream is keyed by the
    absolute step), and log the reference's progress lines."""
    x, y = _data()
    whole = _port_bnn(**SLICE)
    whole.train(x, y)
    chunked = _port_bnn(**dict(SLICE, log_every=3))
    with caplog.at_level(logging.INFO):
        chunked.train(x, y)
    for key, leaf in whole.samples.items():
        assert torch.equal(leaf, chunked.samples[key]), key
    lines = [r.getMessage() for r in caplog.records if "NLL" in r.getMessage()]
    # iteration 0, burn-in 3 + 3 + 2, then one line per collected sample
    assert len(lines) == 1 + 3 + 2
    assert "Samples = 4" in lines[-1]


def test_philox_training_is_reproducible_and_learns():
    x, y = _data()
    kw = dict(SLICE, burn_in_steps=200, n_iters=216, seed=3)
    a = BayesianNeuralNetwork(device="cpu", **kw)
    b = BayesianNeuralNetwork(device="cpu", **kw)
    a.train(x, y)
    b.train(x, y)
    for key, leaf in a.samples.items():
        assert torch.equal(leaf, b.samples[key]), key
    mean, var = a.predict(x)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert np.mean((mean - y) ** 2) < np.var(y)
    assert set(a.phase_seconds) == {"burn_in", "sampling"}


@pytest.mark.parametrize("kwargs", [
    dict(n_nets=0), dict(n_iters=0), dict(burn_in_steps=-1),
    dict(sample_steps=0), dict(batch_size=0), dict(sampling_method="SGHMC"),
    dict(n_chains=0), dict(n_chains=3, n_nets=4), dict(log_every=0),
    dict(network="conv"), dict(step_impl="scan"), dict(units=()),
    dict(network="reference", step_impl="fused"),
    dict(network="dense", step_impl="fused", units=(8,) * 5),
    dict(network="dense", step_impl="fused", units=(8, 9)),
    dict(network="dense", step_impl="fused", get_net=(None, None)),
    dict(pair_dots=True), dict(network="dense", step_impl="fused",
                               units=(8, 8), pair_dots=True),
    dict(network="dense", step_impl="fused", noise_impl="clt"),
    # the CLT generator is the fused kernels', and the paired kernels'
    # noise is Box-Muller
    dict(network="dense", step_impl="lanes", noise_impl="hadamard_clt"),
    dict(network="dense", step_impl="fused", pair_dots=True,
         noise_impl="hadamard_clt"),
    # SVGD ignores step_impl but for JAX's refusals of lanes and fused
    dict(sampling_method="SVGD", step_impl="lanes"),
    dict(sampling_method="SVGD", network="dense", step_impl="fused"),
    dict(sampling_method="SVGD", step_impl="fused"),
    # the fused family's widest hidden layer, JAX's fused_slot
    dict(network="dense", step_impl="fused", units=(115,) * 3),
])
def test_constructor_errors_match_jax(kwargs):
    jax_kwargs = kwargs
    if kwargs.get("sampling_method") == "SVGD":
        jax_kwargs = dict(kwargs,
                          sampling_method=jax_sampling.Sampler.SVGD)
        kwargs = dict(kwargs, sampling_method=Sampler.SVGD)
    with pytest.raises(ValueError) as want:
        JaxBNN(**jax_kwargs)
    with pytest.raises(ValueError) as got:
        BayesianNeuralNetwork(device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(network="dense"),
    dict(network="dense", step_impl="pytree"),
    dict(step_impl="lanes", mesh=object()),
    dict(network="dense", step_impl="fused", mesh=object()),
    dict(network="dense", step_impl="fused", compute_dtype=torch.bfloat16,
         dtype=torch.float64),
    dict(network="dense", step_impl="fused", dtype=torch.float64),
])
def test_unported_paths_raise(kwargs):
    """What the port has not reached raises, naming its ROADMAP.md item
    (``step_impl="lanes"`` and ``"fused"`` train with all five gradient
    samplers)."""
    if "sampling_method" in kwargs:
        kwargs = dict(kwargs, sampling_method=Sampler[
            kwargs["sampling_method"]])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BayesianNeuralNetwork(device="cpu", **kwargs)


def test_fused_placement_follows_the_library_count(monkeypatch):
    """Fault C1, repaired: a launch keeps a chain's state in shared memory
    exactly where the library's own count (``fused_step_smem_bytes``,
    stood in for here; the card tests hold the real one) fits a block, and
    in device memory above it; nothing refuses a wide network, which trains
    on the CPU's plain versions as JAX's interpret path does."""
    asked = []

    class Library:
        @staticmethod
        def fused_step_smem_bytes(kernel_id, n_params, n_inputs, hidden,
                                  depth, batch):
            asked.append((kernel_id, n_params, n_inputs, hidden, depth,
                          batch))
            return _build.MAX_SMEM_BYTES + (hidden > 100)

    monkeypatch.setattr(_build, "load", lambda name: {
        "fused_step": Library}[name])
    wide, narrow = fs.FusedLayout(1, 114, 4), fs.FusedLayout(1, 50, 3)
    assert fs.fused_placement(fs.B2, wide, 20) == "device"
    assert fs.fused_placement(fs.B1, narrow, 20) == "shared"  # at the limit
    assert asked == [(fs.B2, wide.n_params, 1, 114, 4, 20),
                     (fs.B1, narrow.n_params, 1, 50, 3, 20)]
    monkeypatch.undo()
    x, y = _data()
    bnn = BayesianNeuralNetwork(device="cpu", network="dense",
                                step_impl="fused", units=(100,) * 3,
                                n_chains=2, n_nets=2, burn_in_steps=4,
                                sample_steps=2, n_iters=6, log_every=None)
    bnn.train(x, y)
    assert bnn.samples["w2"].shape == (2, 100, 100)
    mean, var = bnn.predict(x)
    assert np.isfinite(mean).all() and np.isfinite(var).all()


def test_fused_drivers_state_dtype_defaults_match_jax():
    """Fault C3, repaired: the fused drivers default to bf16 state and the
    lanes drivers to bf16 network passes with f32 state, as JAX's do."""
    for port_fn, jax_fn, arg, want in (
            (burnin_chain_fused, jax_packed.burnin_chain_fused,
             "state_dtype", torch.bfloat16),
            (sample_chain_fused, jax_packed.sample_chain_fused,
             "state_dtype", torch.bfloat16),
            (burnin_chain_lanes, jax_packed.burnin_chain_lanes,
             "compute_dtype", torch.bfloat16),
            (sample_chain_lanes, jax_packed.sample_chain_lanes,
             "compute_dtype", torch.bfloat16),
            (burnin_chain_lanes, jax_packed.burnin_chain_lanes,
             "state_dtype", torch.float32),
            (sample_chain_lanes, jax_packed.sample_chain_lanes,
             "state_dtype", torch.float32)):
        got = inspect.signature(port_fn).parameters[arg].default
        jax_default = inspect.signature(jax_fn).parameters[arg].default
        assert got is want
        assert jax.numpy.dtype(jax_default).name == str(got).split(".")[1]


def test_default_device_is_the_card(monkeypatch):
    """The entry points run on the card unless the CPU is asked for; without
    a card, train raises instead of running on the CPU."""
    bnn = BayesianNeuralNetwork(**SLICE)
    assert bnn.device == torch.device("cuda")
    assert inspect.signature(dense_network).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bnn.train(x, y)
    assert not bnn.is_trained


def test_train_and_predict_errors_match_jax():
    x, y = _data()
    with pytest.raises(ValueError) as want:
        JaxBNN(**SLICE).predict(x)
    with pytest.raises(ValueError) as got:
        BayesianNeuralNetwork(device="cpu", **SLICE).predict(x)
    assert str(got.value) == str(want.value)
    small = dict(SLICE, n_iters=8)
    with pytest.raises(ValueError) as want:
        JaxBNN(**small).train(x, y)
    with pytest.raises(ValueError) as got:
        BayesianNeuralNetwork(device="cpu", **small).train(x, y)
    assert str(got.value) == str(want.value)
    wide = np.repeat(x, 5, axis=1)
    with pytest.raises(ValueError) as want:
        JaxBNN(**SLICE).train(wide, y)
    with pytest.raises(ValueError) as got:
        BayesianNeuralNetwork(device="cpu", **SLICE).train(wide, y)
    assert str(got.value) == str(want.value)
    with pytest.raises(AssertionError):
        BayesianNeuralNetwork(device="cpu", **SLICE).train(x, y[:, None])


def test_drivers_shapes_and_bookkeeping():
    """burn-in hands the final minv to the sampling phase; positions and
    costs are shaped as in the JAX drivers."""
    x, y = _data()
    n, h = 3, 6
    init, _ = dense_network(1, units=(h, h), device="cpu")
    sampler = SGHMCSampler(lambda p, b: None, stepsize_schedule=0.01,
                           scale_grad=100.0, gaussian_prior_scale=1e-3)
    gen = torch.Generator().manual_seed(0)
    states = sampler.init(init(gen, (n,)))
    burned = burnin_chain_fused(sampler, states, gen, 5, x, y)
    assert int(burned.step) == 5
    for leaf in burned.stats.minv.values():
        assert torch.isfinite(leaf).all() and (leaf > 0).all()
    assert burnin_chain_fused(sampler, burned, gen, 0, x, y) is burned
    out, pos, costs = sample_chain_fused(
        sampler, burned, gen, 2, x, y, keep_every=3, multistep=True)
    assert int(out.step) == 11
    assert costs.shape == (n, 2) and torch.isfinite(costs).all()
    assert pos["w2"].shape == (n, 2, h, h) and pos["w1"].shape == (n, 2, h)
    assert torch.equal(pos["w2"][:, -1], out.position["w2"])
    assert out.stats is burned.stats  # frozen in the sampling phase
    _, none, _ = sample_chain_fused(sampler, burned, gen, 1, x, y,
                                    multistep=True, collect_positions=False)
    assert none is None
    unported = type("PSGLDSampler", (), {})()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sample_chain_fused(unported, burned, gen, 1, x, y)
