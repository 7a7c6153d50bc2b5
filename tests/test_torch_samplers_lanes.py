"""pSGLD, SGNHT and relativistic SGHMC in the port against the JAX package,
and their chains-on-lanes slice.

- The samplers: ``step(noise=)`` over 5 steps from one state (JAX's
  initial momenta and ``xi`` cross through ``interop``), f32 on both sides.
- Kernels B8-psgld, B8-rsghmc and B8-sgnht: the plain versions of
  ``pysgmcmc_tpu_torch.ops.slim_update`` against JAX's Pallas kernels in
  interpret mode on the same inputs and injected noise, in JAX's transposed
  layout, with a scalar and a per-chain eps.
- ``sample_chain_lanes`` against JAX's ``sample_chain_lanes(backend=
  "pallas", interpret=True)`` at 128 chains on the zero-bit stream, as in
  ``tests/test_torch_lanes.py``.
- The relativistic momentum sampler: its variance against quadrature, and a
  two-sample KS test against JAX's draws.
- A small sinc training per sampler through the lanes BNN.

Inputs are made with numpy seeds.  The CUDA kernels are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pysgmcmc_tpu import sampling as jax_sampling
from pysgmcmc_tpu.ops import relativistic as jrel
from pysgmcmc_tpu.ops import slim_update as jsu
from pysgmcmc_tpu.parallel import packed as jpacked
from pysgmcmc_tpu.samplers.psgld import PSGLDSampler as JaxPSGLD
from pysgmcmc_tpu.samplers.relativistic_sghmc import (
    RelativisticSGHMCSampler as JaxRSGHMC,
)
from pysgmcmc_tpu.samplers.sgnht import SGNHTSampler as JaxSGNHT
from pysgmcmc_tpu_torch import interop, sampling
from pysgmcmc_tpu_torch.models import default_network, dense_network
from pysgmcmc_tpu_torch.ops import relativistic as rel
from pysgmcmc_tpu_torch.ops import slim_update as su
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_fused,
    burnin_chain_lanes,
    sample_chain_fused,
    sample_chain_lanes,
)
from pysgmcmc_tpu_torch.samplers import (
    PSGLDSampler,
    RelativisticSGHMCSampler,
    SGNHTSampler,
)
from pysgmcmc_tpu_torch.sampling import Sampler
from pysgmcmc_tpu_torch.utils.pytree import normal_like_tree
from tests.test_torch_lanes import (
    DRIVER_DATA,
    KERNEL_RTOL,
    N_CHAINS,
    P,
    _as_tuple,
    _driver_setup,
    _jax_cost,
    _per_chain_eps,
    _port_cost,
    _train,
)

# sampler -> (JAX class, port class, interop, keywords)
SAMPLERS = {
    "PSGLD": (JaxPSGLD, PSGLDSampler, interop.psgld_state_from_numpy,
              dict(alpha=0.9, lambda_reg=1e-3, scale_grad=float(DRIVER_DATA))),
    "SGNHT": (JaxSGNHT, SGNHTSampler, interop.sgnht_state_from_numpy,
              dict(a_diff=1.5, scale_grad=float(DRIVER_DATA))),
    "RelativisticSGHMC": (JaxRSGHMC, RelativisticSGHMCSampler,
                          interop.rsghmc_state_from_numpy,
                          dict(mass=1.3, speed_of_light=0.7, D=1.2,
                               Bhat=0.1)),
}


def _leaves_close(got, want, tol, label):
    """Every leaf within ``tol`` of the leaf's largest |value|."""
    for key, leaf in want.items():
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(
            np.asarray(got[key]), leaf, rtol=0,
            atol=tol * max(np.abs(leaf).max(), 1e-30),
            err_msg="{} {}".format(label, key))


#  The samplers ----------------------------------------------------------------

# f32 on both sides, autograd on both: summation order in the forward and
# backward passes, carried 5 steps.
STEP_RTOL = 1e-5


@pytest.mark.parametrize("method", sorted(SAMPLERS))
def test_sampler_step_matches_jax(method):
    """Five steps of ``step(noise=)`` from JAX's initial state on JAX-drawn
    noise, with the Gaussian prior fold, within 1e-5 of each leaf's scale
    (``xi`` of its value)."""
    jax_cls, port_cls, from_numpy, kw = SAMPLERS[method]
    x, y, apply, positions = _driver_setup()
    single = jax.tree_util.tree_map(lambda leaf: leaf[0], positions)
    kw = dict(kw, stepsize_schedule=2e-3, gaussian_prior_scale=1e-3)
    jax_sampler = jax_cls(_jax_cost(apply, x, y), **kw)
    state = jax_sampler.init(single, jax.random.PRNGKey(4))
    start = from_numpy(state, "cpu")
    keys = iter(jax.random.split(jax.random.PRNGKey(5), 5 * len(single)))
    noises = [{k: np.asarray(jax.random.normal(next(keys), np.shape(v)))
               for k, v in single.items()} for _ in range(5)]
    for eta in noises:
        state = jax_sampler.step(state, jax.random.PRNGKey(0), noise=eta)[0]

    port_sampler = port_cls(_port_cost(x, y), **kw)
    port_state = start._replace(
        schedule_state=port_sampler.stepsize_schedule.init())
    for eta in noises:
        port_state, info = port_sampler.step(
            port_state, None, noise=interop.params_from_numpy(eta, "cpu"))
    assert int(port_state.step) == int(state.step) == 5
    assert float(info.stepsize) == pytest.approx(2e-3)
    got = interop.state_to_numpy(port_state)
    for field in ("position", "momentum", "v"):
        if hasattr(state, field):
            _leaves_close(got[field], getattr(state, field), STEP_RTOL,
                          field)
    if method == "SGNHT":
        np.testing.assert_allclose(got["xi"], np.asarray(state.xi),
                                   rtol=STEP_RTOL)


def test_sgnht_step_on_stacked_chains_reduces_per_chain():
    """A state whose ``xi`` is one per chain steps every stacked chain as
    it would step alone: ``p^T p`` and ``d`` are per chain."""
    x, y, _, _ = _driver_setup()
    sampler = SGNHTSampler(_port_cost(x, y), stepsize_schedule=0.01)
    init, _ = default_network(1, units=(8, 8), device="cpu")
    positions = init(torch.Generator().manual_seed(0), (3,))
    stacked = sampler.init(positions, torch.Generator().manual_seed(1))
    stacked = stacked._replace(xi=torch.tensor([0.5, 1.0, 2.0]))
    noise = normal_like_tree(torch.Generator().manual_seed(2), positions)
    cost = _port_cost(x, y)
    sampler.cost_fn = lambda p: sum(cost({k: v[i] for k, v in p.items()})
                                    for i in range(3))
    got = sampler.step(stacked, None, noise=noise)[0]
    sampler.cost_fn = cost
    for i in range(3):
        one = stacked._replace(
            position={k: v[i] for k, v in stacked.position.items()},
            momentum={k: v[i] for k, v in stacked.momentum.items()},
            xi=stacked.xi[i])
        want = sampler.step(one, None, noise={k: v[i]
                                              for k, v in noise.items()})[0]
        torch.testing.assert_close(got.xi[i], want.xi)
        for key in want.position:
            torch.testing.assert_close(got.position[key][i],
                                       want.position[key])


def test_sampler_factory_matches_jax():
    for method in SAMPLERS:
        got = sampling.Sampler.get_sampler(sampling.Sampler[method],
                                           cost_fn=abs)
        want = jax_sampling.Sampler.get_sampler(jax_sampling.Sampler[method],
                                                cost_fn=abs)
        assert type(got).__name__ == type(want).__name__, method
        for attr, value in vars(want).items():
            if isinstance(value, (int, float)):
                assert getattr(got, attr) == value, (method, attr)
        for kwargs in (dict(cost_fn=abs, burn_in_steps=10),
                       dict(stepsize_schedule=0.1)):
            with pytest.raises(ValueError) as port_err:
                sampling.Sampler.get_sampler(sampling.Sampler[method],
                                             **kwargs)
            with pytest.raises(ValueError) as jax_err:
                jax_sampling.Sampler.get_sampler(
                    jax_sampling.Sampler[method], **kwargs)
            assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("method", sorted(SAMPLERS))
def test_state_from_numpy_round_trip(method):
    jax_cls, _, from_numpy, kw = SAMPLERS[method]
    _, _, _, positions = _driver_setup()
    state = jax.vmap(jax_cls(lambda p: 0.0, **kw).init)(
        positions, jax.random.split(jax.random.PRNGKey(0), N_CHAINS))
    back = interop.state_to_numpy(from_numpy(state, "cpu"))
    for field in ("position", "momentum", "v"):
        if hasattr(state, field):
            for key, leaf in getattr(state, field).items():
                np.testing.assert_array_equal(back[field][key],
                                              np.asarray(leaf))
    if method == "SGNHT":
        assert back["xi"].shape == (N_CHAINS,)
        np.testing.assert_array_equal(back["xi"], np.asarray(state.xi))


def test_sampler_inits_draw_from_the_generator():
    params = {"w": torch.zeros(400)}
    sgnht = SGNHTSampler(abs)
    assert torch.equal(sgnht.init(params).momentum["w"], params["w"])
    a = sgnht.init(params, torch.Generator().manual_seed(3)).momentum["w"]
    b = sgnht.init(params, torch.Generator().manual_seed(3)).momentum["w"]
    assert torch.equal(a, b) and 0.8 < float(a.std()) < 1.2
    assert float(sgnht.init(params).xi) == 1.0
    rsghmc = RelativisticSGHMCSampler(abs)
    assert torch.equal(rsghmc.init(params).momentum["w"],
                       rsghmc.init(params).momentum["w"])  # seed 0
    psgld = PSGLDSampler(abs).init(params)
    assert torch.equal(psgld.v["w"], params["w"])


#  The three kernels -------------------------------------------------------------

def _kernel_inputs(seed=0):
    """``(n_chains, P)`` float32 arrays: pSGLD's accumulator on the scale of
    g^2, momenta of order one, one thermostat per chain."""
    rng = np.random.RandomState(seed)

    def arr():
        return rng.standard_normal((N_CHAINS, P)).astype(np.float32)

    out = {"theta": arr(), "p": arr(), "grad": arr(), "noise": arr(),
           "v": rng.uniform(0.0, 2.0, (N_CHAINS, P)).astype(np.float32),
           "xi": rng.uniform(0.5, 1.5, N_CHAINS).astype(np.float32)}
    out["v"][0, 0] = 0.0
    return out


# kernel -> (JAX kernel, port plain version, state operands, rule keywords)
KERNELS = {
    "B8-psgld": (jsu.slim_psgld_update, su.slim_psgld_update_ref,
                 ("theta", "v", "grad"),
                 dict(alpha=0.95, lambda_reg=1e-3, scale_grad=10.0)),
    "B8-rsghmc": (jsu.slim_rsghmc_update, su.slim_rsghmc_update_ref,
                  ("theta", "p", "grad"),
                  dict(d_coef=1.2, bhat=0.3, mass=1.3, speed_of_light=0.7)),
    "B8-sgnht": (jsu.slim_sgnht_update, su.slim_sgnht_update_ref,
                 ("theta", "p", "grad"), dict(a_diff=1.5, scale_grad=10.0)),
}
PRIOR = 0.125


def _port_kernel(kernel, inputs, eps, noise=True, step=0):
    _, ref, names, rule = KERNELS[kernel]
    args = [torch.tensor(inputs[k]) for k in names] + [None]
    if kernel == "B8-sgnht":
        args.append(torch.tensor(inputs["xi"]))
    return ref(*args, eps, 7, noise=torch.tensor(inputs["noise"])
               if noise else None, step=step, prior_scale=PRIOR, **rule)


@pytest.mark.parametrize("per_chain", [False, True], ids=["scalar", "row"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_version_matches_pallas_kernel(kernel, per_chain):
    jax_fn, _, names, rule = KERNELS[kernel]
    inputs = _kernel_inputs()
    eps = _per_chain_eps() if per_chain else 0.05
    args = [jnp.asarray(inputs[k].T) for k in names] + [None]
    if kernel == "B8-sgnht":
        args.append(jnp.asarray(inputs["xi"][None, :]))
    want = jax_fn(*args, jnp.asarray(eps), 0,
                  noise=jnp.asarray(inputs["noise"].T), interpret=True,
                  prior_scale=PRIOR, **rule)
    got = _port_kernel(kernel, inputs,
                       torch.tensor(eps) if per_chain else eps)
    assert len(got) == len(want) == 2
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b).T
        np.testing.assert_allclose(a.numpy(), b, rtol=KERNEL_RTOL,
                                   atol=KERNEL_RTOL * np.abs(b).max(),
                                   err_msg="output {}".format(i))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_per_chain_eps_matches_scalar_runs(kernel):
    """A per-chain eps vector equals the scalar runs, chain for chain, on
    the injected and on the Philox stream."""
    inputs = _kernel_inputs(1)
    half = N_CHAINS // 2
    for noise in (True, False):
        runs = [_port_kernel(kernel, inputs, eps, noise, step=3)
                for eps in (0.05, 0.002, torch.tensor(_per_chain_eps()))]
        for a, b, row in zip(*runs):
            assert torch.equal(row[:half], a[:half])
            assert torch.equal(row[half:], b[half:])


def test_new_wrappers_refuse_what_they_cannot_take():
    inputs = _kernel_inputs()
    theta, p, grad = (torch.tensor(inputs[k]) for k in ("theta", "p", "grad"))
    xi = torch.tensor(inputs["xi"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        su.slim_psgld_update(theta, p, grad, torch.ones(1, P), 0.01, 0)
    with pytest.raises(ValueError, match="match theta"):
        su.slim_rsghmc_update(theta, p[:, :3], grad, None, 0.01, 0)
    for bad in (xi[:3], xi.double(), xi[None, :]):
        with pytest.raises(ValueError, match="xi"):
            su.slim_sgnht_update(theta, p, grad, None, bad, 0.01, 0)
    for fn, args in ((su.slim_psgld_update, (theta, p, grad, None)),
                     (su.slim_rsghmc_update, (theta, p, grad, None)),
                     (su.slim_sgnht_update, (theta, p, grad, None, xi))):
        launches = fn.launches
        out = fn(*args, 0.01, 0)
        assert fn.launches == launches  # plain version: no launch
        assert all(torch.isfinite(t).all() for t in _as_tuple(out))


#  The lanes driver against JAX's interpret-mode driver -------------------------

# As tests/test_torch_lanes.py: summation order (XLA vs ATen) in the
# forward and backward passes, carried 16 steps; 2e-5 of each leaf's
# largest |value|.
DRIVER_RTOL = 2e-5


@pytest.mark.parametrize("method", sorted(SAMPLERS))
def test_lanes_driver_matches_jax_interpret(method):
    jax_cls, port_cls, from_numpy, kw = SAMPLERS[method]
    x, y, apply, positions = _driver_setup()
    kw = dict(kw, stepsize_schedule=1e-3)
    jax_sampler = jax_cls(_jax_cost(apply, x, y), **kw)
    states = jax.vmap(jax_sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(1), N_CHAINS))
    want_states, want_pos, want_costs = jpacked.sample_chain_lanes(
        jax_sampler, states, jax.random.PRNGKey(3), 2, keep_every=8,
        batch_fn=None, compute_dtype=None, backend="pallas", interpret=True)

    sampler = port_cls(_port_cost(x, y), **kw)
    start = from_numpy(states, "cpu")._replace(
        schedule_state=sampler.stepsize_schedule.init(),
        step=torch.zeros((), dtype=torch.int64))
    got_states, got_pos, got_costs = sample_chain_lanes(
        sampler, start, torch.Generator().manual_seed(0), 2, keep_every=8,
        compute_dtype=None, noise_impl="zero")

    assert int(got_states.step) == int(want_states.step[0]) == 16
    for key, leaf in want_pos.items():
        assert got_pos[key].shape == np.shape(leaf), key
    _leaves_close(got_pos, want_pos, DRIVER_RTOL, "positions")
    for field in ("momentum", "v"):
        if hasattr(want_states, field):
            _leaves_close(getattr(got_states, field),
                          getattr(want_states, field), DRIVER_RTOL, field)
    if method == "SGNHT":
        assert got_states.xi.shape == (N_CHAINS,)
        np.testing.assert_allclose(got_states.xi.numpy(),
                                   np.asarray(want_states.xi),
                                   rtol=DRIVER_RTOL)
    np.testing.assert_allclose(got_costs.numpy(), np.asarray(want_costs),
                               rtol=DRIVER_RTOL)


def _small(cls, **kw):
    x, y, _, _ = _driver_setup()
    return cls(_port_cost(x, y), stepsize_schedule=1e-3, **kw)


def test_sgnht_driver_takes_a_shared_or_a_per_chain_xi():
    sampler = _small(SGNHTSampler)
    init, _ = default_network(1, units=(8, 8), device="cpu")
    states = sampler.init(init(torch.Generator().manual_seed(0), (4,)),
                          torch.Generator().manual_seed(1))
    assert states.xi.ndim == 0

    def run(start):
        return sample_chain_lanes(sampler, start,
                                  torch.Generator().manual_seed(2), 1,
                                  keep_every=3)

    shared, pos, _ = run(states)
    assert shared.xi.shape == (4,) and int(shared.step) == 3
    per_chain, pos2, _ = run(states._replace(xi=torch.full((4,), 1.0)))
    assert torch.equal(shared.xi, per_chain.xi)
    for key in pos:
        assert torch.equal(pos[key], pos2[key])
    with pytest.raises(ValueError, match="xi"):
        run(states._replace(xi=torch.ones(3)))


@pytest.mark.parametrize("cls", [PSGLDSampler, SGNHTSampler,
                                 RelativisticSGHMCSampler])
def test_drivers_route_the_samplers_without_burn_in(cls):
    """The burn-in drivers refuse them, naming ``sample_chain_lanes``; both
    sampling drivers take them (the fused one on the dense network)."""
    sampler = _small(cls)
    init, _ = default_network(1, units=(8, 8), device="cpu")
    states = sampler.init(init(torch.Generator().manual_seed(0), (2,)))
    gen = torch.Generator().manual_seed(0)
    x, y, _, _ = _driver_setup()
    for driver, args in ((burnin_chain_lanes, ()),
                         (burnin_chain_fused, (x, y))):
        with pytest.raises(NotImplementedError, match="sample_chain_lanes"):
            driver(sampler, states, gen, 2, *args)
    out, pos, costs = sample_chain_lanes(sampler, states, gen, 2,
                                         keep_every=2)
    assert costs.shape == (2, 2) and torch.isfinite(costs).all()
    assert pos["w1"].shape == (2, 2, 1, 8)
    assert torch.equal(pos["w2"][:, -1], out.position["w2"])
    assert type(out) is type(states) and int(out.step) == 4
    dense, _ = dense_network(1, units=(8, 8), device="cpu")
    states = sampler.init(dense(torch.Generator().manual_seed(0), (2,)))
    out, pos, costs = sample_chain_fused(sampler, states, gen, 2, x, y,
                                         keep_every=2, multistep=True)
    assert costs.shape == (2, 2) and torch.isfinite(costs).all()
    assert pos["w1"].shape == (2, 2, 8)
    assert type(out) is type(states) and int(out.step) == 4


#  The relativistic momentum sampler ---------------------------------------------

def _marginal_variance(m, c):
    grid = np.linspace(-80, 80, 400001)
    pdf = np.exp(-m * c**2 * np.sqrt(grid**2 / (m**2 * c**2) + 1))
    pdf /= np.trapezoid(pdf, grid)
    return np.trapezoid(grid**2 * pdf, grid)


@pytest.mark.parametrize("m,c,tol", [(1.0, 1.0, 0.03), (2.0, 1.5, 0.05),
                                     (3.0, 2.0, 0.05)])
def test_momentum_marginal_variance(m, c, tol):
    """The tolerances of tests/samplers/test_relativistic_sghmc.py."""
    draws = rel.sample_relativistic_momentum(
        torch.Generator().manual_seed(0), (200_000,), m=m, c=c).numpy()
    true_var = _marginal_variance(m, c)
    assert abs(draws.mean()) < 0.02
    assert abs(draws.var() - true_var) / true_var < tol


@pytest.mark.parametrize("m,c", [(1.0, 1.0), (1.3, 0.7)])
def test_momentum_draws_match_jax_in_distribution(m, c):
    """Two-sample KS test against JAX's draws (the streams differ)."""
    ours = rel.sample_relativistic_momentum(
        torch.Generator().manual_seed(1), (20_000,), m=m, c=c).numpy()
    theirs = np.asarray(jrel.sample_relativistic_momentum(
        jax.random.PRNGKey(1), (20_000,), m=m, c=c))
    assert stats.ks_2samp(ours, theirs).pvalue > 1e-3


def test_momentum_tree_and_kinetic_energy():
    tree = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.float64)}
    gen = torch.Generator().manual_seed(2)
    draws = rel.sample_relativistic_momentum_tree(gen, tree, m=1.3, c=0.7)
    assert draws["a"].shape == (3, 4) and draws["b"].dtype == torch.float64
    p = torch.tensor([0.0, 0.5, -2.0])
    np.testing.assert_allclose(
        rel.relativistic_kinetic_energy(p, 1.3, 0.7).numpy(),
        np.asarray(jrel.relativistic_kinetic_energy(jnp.asarray(p.numpy()),
                                                    1.3, 0.7)), rtol=1e-6)
    np.testing.assert_allclose(float(rel._optimal_tilt(torch.tensor(0.637))),
                               float(jrel._optimal_tilt(0.637)), rtol=1e-6)


#  The lanes BNN -------------------------------------------------------------------

# stepsizes from the JAX package's lanes BNN on sinc
SMALL_TRAIN = {"PSGLD": 3e-3, "RelativisticSGHMC": 1e-3, "SGNHT": 3e-4}


@pytest.mark.parametrize("method", sorted(SMALL_TRAIN))
def test_lanes_bnn_learns_sinc(method):
    bnn = _train(sampling_method=Sampler[method], network="reference",
                 step_impl="lanes", units=(16, 16), n_chains=4, n_nets=8,
                 burn_in_steps=300, sample_steps=10, n_iters=320,
                 stepsize_schedule=SMALL_TRAIN[method])
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    mean, var = bnn.predict(x_grid)
    assert mean.shape == var.shape == (50,)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    mse = np.mean((mean - np.sinc(x_grid[:, 0] * 10 - 5)) ** 2)
    if method != "SGNHT":
        assert mse < 0.1, mse
    assert set(bnn.phase_seconds) == {"burn_in", "sampling"}


@pytest.mark.parametrize("method", sorted(SMALL_TRAIN))
def test_lanes_bnn_builds_the_sampler_as_jax(method):
    """``scale_grad`` = N where the sampler has one, no burn-in length, and
    the same seed gives the same chains (initial momenta included)."""
    kw = dict(sampling_method=Sampler[method], network="reference",
              step_impl="lanes", units=(8,), n_chains=2, n_nets=2,
              burn_in_steps=4, sample_steps=2, n_iters=6, log_every=None)
    a, b = _train(**kw), _train(**kw)
    for key in a.samples:
        assert torch.equal(a.samples[key], b.samples[key]), key
    sampler = a._build_sampler(abs, 100)
    assert getattr(sampler, "scale_grad", 100.0) == 100.0
    assert not hasattr(sampler, "burn_in_steps")
