"""SVGD in the port against the JAX package: the slice of
``BayesianNeuralNetwork(sampling_method=Sampler.SVGD)``.

- ``utils.numeric.median`` and ``ops.pairwise`` against JAX's (and
  ``median`` against ``numpy.median``), odd and even sizes, rtol 1e-6.
- Kernel B11: the plain version ``svgd_phi_streaming_ref`` against JAX's
  ``svgd_phi_streaming(interpret=True)`` at JAX's own test shapes, with
  JAX's tolerance (rtol 1e-4, atol 1e-5).
- ``SVGDSampler.step`` against JAX's, dense and streaming, 5 steps on the
  Gaussian of ``tests/test_svgd_streaming.py``.
- The slice as a whole: the BNN's SVGD training against JAX's from JAX's
  particles, with one minibatch window (the whole data) so that both sides
  are deterministic, then the predictions.
- The BNN's prior constants, built on the device by fills, keep the bits
  of the host copies they replace.

Inputs are made with numpy seeds.  JAX runs its Pallas kernel in interpret
mode on the CPU, with ``jax.block_until_ready`` and ``jax.effects_barrier``
after each call inside a loop (see ``tests/conftest.py``).  The CUDA kernel
is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu import sampling as jax_sampling
from pysgmcmc_tpu.models.architectures import default_network as jax_default
from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork as JaxBNN,
)
from pysgmcmc_tpu.ops import pairwise as jpw
from pysgmcmc_tpu.ops.svgd_streaming import svgd_phi_streaming as jax_phi
from pysgmcmc_tpu.samplers.svgd import SVGDSampler as JaxSVGD
from pysgmcmc_tpu.utils import numeric as jax_numeric
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork
from pysgmcmc_tpu_torch.models.bayesian_neural_network import (
    log_variance_prior_log_like,
    weight_prior_log_like,
)
from pysgmcmc_tpu_torch.ops import pairwise
from pysgmcmc_tpu_torch.ops import svgd_streaming as ss
from pysgmcmc_tpu_torch.samplers import SVGDSampler, SVGDState
from pysgmcmc_tpu_torch.sampling import Sampler
from pysgmcmc_tpu_torch.utils import numeric

PAIRWISE_RTOL = 1e-6
# JAX's own bounds for its streaming kernel (tests/test_svgd_streaming.py)
PHI_RTOL, PHI_ATOL = 1e-4, 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
# the BNN slice: samples and predictions within this share of each leaf's
# (each output's) largest magnitude
SLICE_REL = 1e-4
# JAX's streaming test shapes: (n, d, tile)
PHI_SHAPES = [(256, 3, 64), (128, 130, 32), (100, 2, 64), (97, 5, 32),
              (130, 3, 128)]


def _points(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("size", [1, 2, 7, 8, 97, 256])
def test_median_matches_jax_and_numpy(size):
    x = np.random.default_rng(size).normal(size=size).astype(np.float32)
    got = float(numeric.median(torch.as_tensor(x)))
    assert got == float(jax_numeric.median(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.median(x), rtol=PAIRWISE_RTOL)
    # an n x n matrix has an even count: the mean of the central two
    m = torch.as_tensor(x[:, None] * x[None, :])
    np.testing.assert_allclose(float(numeric.median(m)),
                               np.median(m.numpy()), rtol=PAIRWISE_RTOL)


@pytest.mark.parametrize("n,d", [(7, 3), (8, 130)])
def test_pairwise_matches_jax(n, d):
    x = _points(n, d, seed=n)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    d2 = pairwise.squared_distance_matrix(xt)
    jd2 = jpw.squared_distance_matrix(xj)
    # the Gram expansion cancels on the diagonal: hold it to the scale of
    # the rows' squared norms there
    scale = float(np.max(np.sum(x * x, axis=1)))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2),
                               rtol=PAIRWISE_RTOL, atol=PAIRWISE_RTOL * scale)
    np.testing.assert_allclose(pairwise.pdist(xt).numpy(),
                               np.asarray(jpw.pdist(xj)), rtol=PAIRWISE_RTOL)
    cond = pairwise.pdist(xt)
    np.testing.assert_array_equal(
        pairwise.squareform(cond).numpy(),
        np.asarray(jpw.squareform(jnp.asarray(cond.numpy()))))
    np.testing.assert_allclose(
        float(pairwise.median_bandwidth(d2, n)),
        float(jpw.median_bandwidth(jnp.asarray(d2.numpy()), n)),
        rtol=PAIRWISE_RTOL)
    kernel, grad_kernel = pairwise.svgd_kernel(xt)
    jkernel, jgrad_kernel = jpw.svgd_kernel(xj)
    np.testing.assert_allclose(kernel.numpy(), np.asarray(jkernel),
                               rtol=PAIRWISE_RTOL, atol=PAIRWISE_RTOL)
    np.testing.assert_allclose(
        grad_kernel.numpy(), np.asarray(jgrad_kernel), rtol=PAIRWISE_RTOL,
        atol=PAIRWISE_RTOL * float(np.abs(jgrad_kernel).max()))


@pytest.mark.parametrize("n,d,tile", PHI_SHAPES)
def test_plain_streaming_matches_pallas_kernel(n, d, tile):
    x, g = _points(n, d, seed=1), _points(n, d, seed=2)
    h = float(jpw.median_bandwidth(jpw.squared_distance_matrix(
        jnp.asarray(x)), n))
    want = jax_phi(jnp.asarray(x), jnp.asarray(g), h, tile=tile,
                   interpret=True)
    jax.block_until_ready(want)
    jax.effects_barrier()
    got = ss.svgd_phi_streaming(torch.as_tensor(x), torch.as_tensor(g), h,
                                tile=tile)
    assert got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PHI_RTOL,
                               atol=PHI_ATOL)
    # the column chunk is the plain version's own: any gives the same phi
    np.testing.assert_allclose(
        ss.svgd_phi_streaming_ref(torch.as_tensor(x), torch.as_tensor(g),
                                  torch.tensor(h), tile=n).numpy(),
        got.numpy(), rtol=PHI_RTOL, atol=PHI_ATOL)


def test_streaming_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros(4, 3)
    for bad in (torch.zeros(4, 2), torch.zeros(4, 3, dtype=torch.float64)):
        with pytest.raises(ValueError, match="one shape"):
            ss.svgd_phi_streaming(x, bad, 1.0)
    with pytest.raises(ValueError, match="scalar"):
        ss.svgd_phi_streaming(x, x, torch.ones(2))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ss.svgd_phi_streaming(x.to("meta"), x.to("meta"), 1.0)


def _gaussian(x):
    return 0.5 * torch.sum(x["x"] ** 2)


def _jax_gaussian(x):
    return 0.5 * jnp.sum(x["x"] ** 2)


@pytest.mark.parametrize("kernel_impl", ["dense", "streaming"])
def test_sampler_step_matches_jax(kernel_impl):
    """5 steps on the Gaussian of tests/test_svgd_streaming.py, from its
    ensemble: positions, Adagrad accumulators, costs and stepsizes.  (At
    rtol 1e-4 / atol 1e-6 a coordinate near 0 after 5 Adagrad steps sits at
    the edge of f32 rounding: from other ensembles JAX's own streaming and
    dense steps differ by up to 1.7e-6 beyond that bound.)"""
    kw = dict(stepsize_schedule=0.3, kernel_impl=kernel_impl)
    if kernel_impl == "streaming":
        kw.update(streaming_tile=32, streaming_interpret=True)
    particles = np.array(
        jax.random.normal(jax.random.PRNGKey(0), (64, 2)) * 2.0)
    jsampler = JaxSVGD(_jax_gaussian, **kw)
    sampler = SVGDSampler(_gaussian, **kw)
    jstate = jsampler.init({"x": jnp.asarray(particles)})
    state = sampler.init({"x": torch.as_tensor(particles)})
    gen = torch.Generator().manual_seed(0)
    for i in range(5):
        jstate, jinfo = jsampler.step(jstate, jax.random.PRNGKey(i))
        jax.block_until_ready(jstate.position)
        jax.effects_barrier()
        state, info = sampler.step(state, gen)
        for got, want in ((state.position, jstate.position),
                          (state.historical_grad, jstate.historical_grad)):
            np.testing.assert_allclose(got["x"].numpy(),
                                       np.asarray(want["x"]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)
        np.testing.assert_allclose(info.cost.numpy(),
                                   np.asarray(jinfo.cost), rtol=STEP_RTOL)
        assert float(info.stepsize) == float(jinfo.stepsize)
        assert int(state.step) == int(jstate.step) == i + 1


def test_svgd_state_carries_across():
    """A JAX SVGDState carried into the port steps on as JAX's does."""
    jsampler = JaxSVGD(_jax_gaussian, stepsize_schedule=0.1)
    jstate = jsampler.init({"x": jnp.asarray(_points(16, 3, seed=4))})
    for i in range(2):
        jstate, _ = jsampler.step(jstate, jax.random.PRNGKey(i))
    state = interop.svgd_state_from_numpy(jstate, "cpu")
    assert isinstance(state, SVGDState) and int(state.step) == 2
    out = interop.state_to_numpy(state)
    np.testing.assert_array_equal(out["historical_grad"]["x"],
                                  np.asarray(jstate.historical_grad["x"]))
    jstate, _ = jsampler.step(jstate, jax.random.PRNGKey(2))
    state, _ = SVGDSampler(_gaussian, stepsize_schedule=0.1).step(
        state, torch.Generator())
    np.testing.assert_allclose(state.position["x"].numpy(),
                               np.asarray(jstate.position["x"]),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


def test_bandwidth_subsample_comes_from_the_generator():
    """Beyond ``bandwidth_subsample`` particles the bandwidth comes from a
    subsample drawn from the step's generator: one seed, one step."""
    sampler = SVGDSampler(_gaussian, kernel_impl="streaming",
                          bandwidth_subsample=32)
    state = sampler.init({"x": torch.as_tensor(_points(200, 2, seed=5))})
    runs = [sampler.step(state, torch.Generator().manual_seed(seed))[0]
            for seed in (1, 1, 2)]
    assert torch.equal(runs[0].position["x"], runs[1].position["x"])
    assert not torch.equal(runs[0].position["x"], runs[2].position["x"])


def test_sampler_factory_matches_jax():
    got = Sampler.get_sampler(Sampler.SVGD, cost_fn=_gaussian)
    want = jax_sampling.Sampler.get_sampler(jax_sampling.Sampler.SVGD,
                                            cost_fn=_jax_gaussian)
    assert type(got).__name__ == type(want).__name__ == "SVGDSampler"
    for attr in ("alpha", "fudge_factor", "kernel_impl",
                 "bandwidth_subsample", "streaming_tile",
                 "streaming_interpret"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for kwargs in (dict(cost_fn=_gaussian, mdecay=0.05),
                   dict(cost_fn=_gaussian, alpha="a lot"),
                   dict(cost_fn=_gaussian, kernel_impl="magic")):
        with pytest.raises(ValueError) as err:
            Sampler.get_sampler(Sampler.SVGD, **kwargs)
        with pytest.raises(ValueError) as ref:
            jax_sampling.Sampler.get_sampler(jax_sampling.Sampler.SVGD,
                                             **kwargs)
        assert str(err.value) == str(ref.value)


#  The slice: the BNN's SVGD training ---------------------------------------

SLICE = dict(units=(8, 8), n_nets=8, n_iters=10, batch_size=20)


def _sinc(n=20):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (n, 1))
    return x, np.sinc(x[:, 0] * 10 - 5)


def _jax_particles(seed, n_nets):
    """The particles JAX's _train_svgd draws: vmap(init)(split(key_net))."""
    key_net = jax.random.split(jax.random.PRNGKey(seed), 4)[0]
    init, _ = jax_default(1, units=SLICE["units"])
    return jax.vmap(init)(jax.random.split(key_net, n_nets))


@pytest.fixture(scope="module", params=["dense", "streaming"])
def trained(request):
    kw = dict(SLICE, kernel_impl=request.param)
    if request.param == "streaming":
        kw["streaming_interpret"] = True
    x, y = _sinc()
    jax_bnn = JaxBNN(sampling_method=jax_sampling.Sampler.SVGD, **kw)
    jax_bnn.train(x, y)
    jax.effects_barrier()
    port_bnn = BayesianNeuralNetwork(sampling_method=Sampler.SVGD,
                                     device="cpu", **kw)
    particles = interop.params_from_numpy(
        _jax_particles(port_bnn.seed, port_bnn.n_nets), "cpu")
    port_bnn._initial_positions = lambda init_fn, generator, n: particles
    port_bnn.train(x, y)
    return jax_bnn, port_bnn


def test_svgd_samples_match_jax(trained):
    jax_bnn, port_bnn = trained
    assert set(port_bnn.samples) == set(jax_bnn.samples)
    assert port_bnn._n_collected == jax_bnn._n_collected == SLICE["n_nets"]
    for key, want in jax_bnn.samples.items():
        want = np.asarray(want)
        got = port_bnn.samples[key].numpy()
        assert got.shape == want.shape, key
        assert np.abs(got - want).max() <= SLICE_REL * np.abs(want).max(), key
    assert set(port_bnn.phase_seconds) == {"transport"}


def test_svgd_predict_matches_jax(trained):
    jax_bnn, port_bnn = trained
    grid = np.linspace(0.0, 1.0, 50)[:, None]
    for individual in (False, True):
        want = jax_bnn.predict(grid, return_individual_predictions=individual)
        got = port_bnn.predict(grid, return_individual_predictions=individual)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= SLICE_REL * np.abs(w).max()


def test_svgd_bnn_constructs_with_defaults():
    """SVGD ignores step_impl, as in JAX: the default "pytree" constructs,
    on the card by default."""
    bnn = BayesianNeuralNetwork(sampling_method=Sampler.SVGD)
    assert bnn.step_impl == "pytree"
    assert bnn.device == torch.device("cuda")
    assert BayesianNeuralNetwork(sampling_method=Sampler.SVGD,
                                 network="dense",
                                 kernel_impl="streaming").sampler_kwargs == {
        "kernel_impl": "streaming"}


#  The BNN's prior constants -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prior_constants_keep_the_host_copies_bits(dtype):
    """The priors' device scalars are fills of the same values as the host
    copies (``torch.as_tensor``) they replace: the same bits."""
    gen = torch.Generator().manual_seed(3)
    log_var = torch.randn((20, 1), generator=gen, dtype=dtype) - 3.0
    params = {"w": torch.randn((4, 5), generator=gen, dtype=dtype),
              "b": torch.randn((5,), generator=gen, dtype=dtype)}
    mean = torch.as_tensor(1e-6, dtype=dtype)
    var = torch.as_tensor(0.01, dtype=dtype)
    want_var = torch.mean(torch.sum(
        numeric.safe_divide(-torch.square(log_var - torch.log(mean)),
                            2.0 * var) - 0.5 * torch.log(var), dim=1))
    log_like = sum(torch.sum(-0.5 * torch.square(leaf))
                   for leaf in params.values())
    want_weight = numeric.safe_divide(log_like, torch.as_tensor(
        25, dtype=log_like.dtype))
    got_var = log_variance_prior_log_like(log_var)
    got_weight = weight_prior_log_like(params)
    assert got_var.dtype == got_weight.dtype == dtype
    assert torch.equal(got_var, want_var)
    assert torch.equal(got_weight, want_weight)
