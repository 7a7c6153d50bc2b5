"""The chains-on-lanes slice of the port against the JAX package.

- Kernels B7, B8-sgld, B9-sghmc and B9-sgld: the plain versions of
  ``pysgmcmc_tpu_torch.ops.slim_update`` against JAX's Pallas kernels in
  interpret mode on the same inputs and injected noise, within JAX's own
  bound between those kernels and their jnp mirror (rtol 1e-6,
  ``tests/parallel/test_burnin_lanes.py``); JAX's layout is the transpose
  of the port's ``(n_chains, P)``.
- The lanes drivers against JAX's ``burnin_chain_lanes`` +
  ``sample_chain_lanes(backend="pallas", interpret=True)`` at 128 chains
  with a full-data cost: interpret mode reads zero PRNG bits, which
  Box-Muller turns into zero noise, and the port's ``noise_impl="zero"`` is
  that stream.  Weights cross with ``interop.params_from_numpy``, which
  hands the dict over in JAX's sorted key order.
- The lanes BNN: on the dense network against the port's fused BNN, and on
  the reference network against the dense one, on the degenerate stream;
  and a small sinc training.

Inputs are made with numpy seeds.  The CUDA kernels are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.models.architectures import default_network as jax_default
from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork as JaxBNN,
)
from pysgmcmc_tpu.ops import slim_update as jsu
from pysgmcmc_tpu.parallel import packed as jpacked
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler as JaxSGHMC
from pysgmcmc_tpu.samplers.sgld import SGLDSampler as JaxSGLD
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.models import (
    BayesianNeuralNetwork,
    default_network,
    dense_network,
)
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.ops import slim_update as su
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_lanes,
    make_lanes_spec,
    pack_lanes,
    sample_chain_lanes,
    unpack_lanes,
)
from pysgmcmc_tpu_torch.samplers import SGHMCSampler, SGLDSampler
from pysgmcmc_tpu_torch.sampling import Sampler
from pysgmcmc_tpu_torch.stepsize_schedules import TracedStepsizeSchedule

N_CHAINS = 128  # JAX's slim kernels need a multiple of 128 chains
P = 40
EPS_A, EPS_B = 0.05, 0.002
CONSTANTS = dict(scale_grad=10.0, prior_scale=0.125)
# within 1e-6 of each value and of its output's largest |value|: an output
# that cancels to near 0 (theta + delta) keeps the rounding of its terms
KERNEL_RTOL = 1e-6


#  The four kernels -------------------------------------------------------------

def _kernel_inputs(seed=0):
    """``(n_chains, P)`` float32 arrays in the EMAs' range (one v_hat entry
    0, to reach the guards)."""
    rng = np.random.RandomState(seed)

    def arr(lo=None, hi=None):
        if lo is None:
            return rng.standard_normal((N_CHAINS, P)).astype(np.float32)
        return rng.uniform(lo, hi, (N_CHAINS, P)).astype(np.float32)

    out = {"theta": arr(), "v": 1e-2 * arr(), "grad": arr(),
           "minv": arr(0.1, 2.0), "tau": arr(1.0, 5.0), "g": arr(),
           "v_hat": arr(0.0, 5.0), "noise": arr()}
    out["v_hat"][0, 0] = 0.0
    return out


# kernel -> (JAX kernel, port plain version, state operands, rule keyword)
KERNELS = {
    "B7": (jsu.slim_sghmc_update, su.slim_sghmc_update_ref,
           ("theta", "v", "grad", "minv"), dict(mdecay=0.05)),
    "B8-sgld": (jsu.slim_sgld_update, su.slim_sgld_update_ref,
                ("theta", "grad", "minv"), dict(a_coef=1.0)),
    "B9-sghmc": (jsu.slim_sghmc_burnin_update,
                 su.slim_sghmc_burnin_update_ref,
                 ("theta", "v", "tau", "g", "v_hat", "grad"),
                 dict(mdecay=0.05)),
    "B9-sgld": (jsu.slim_sgld_burnin_update, su.slim_sgld_burnin_update_ref,
                ("theta", "tau", "g", "v_hat", "grad"), dict(a_coef=1.0)),
}


def _per_chain_eps():
    return np.where(np.arange(N_CHAINS) < N_CHAINS // 2, EPS_A,
                    EPS_B).astype(np.float32)


def _port_kernel(fn, names, rule, inputs, eps, noise=True, step=0):
    args = [torch.tensor(inputs[k]) for k in names]
    return fn(*args, None, eps, 7, noise=torch.tensor(inputs["noise"])
              if noise else None, step=step, **rule, **CONSTANTS)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("per_chain", [False, True], ids=["scalar", "row"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_version_matches_pallas_kernel(kernel, per_chain):
    jax_fn, ref, names, rule = KERNELS[kernel]
    inputs = _kernel_inputs()
    eps = _per_chain_eps() if per_chain else EPS_A
    want = _as_tuple(jax_fn(
        *[jnp.asarray(inputs[k].T) for k in names], None,
        jnp.asarray(eps), 0, noise=jnp.asarray(inputs["noise"].T),
        interpret=True, **rule, **CONSTANTS))
    got = _as_tuple(_port_kernel(ref, names, rule, inputs,
                                 torch.tensor(eps) if per_chain else eps))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b).T
        np.testing.assert_allclose(a.numpy(), b, rtol=KERNEL_RTOL,
                                   atol=KERNEL_RTOL * np.abs(b).max(),
                                   err_msg="output {}".format(i))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_per_chain_eps_matches_scalar_runs(kernel):
    """A per-chain eps vector equals the scalar runs, chain for chain, on
    the injected and on the Philox stream."""
    _, ref, names, rule = KERNELS[kernel]
    inputs = _kernel_inputs(1)
    half = N_CHAINS // 2
    for noise in (True, False):
        runs = [_as_tuple(_port_kernel(ref, names, rule, inputs, eps, noise,
                                       step=3))
                for eps in (EPS_A, EPS_B, torch.tensor(_per_chain_eps()))]
        for a, b, row in zip(*runs):
            assert torch.equal(row[:half], a[:half])
            assert torch.equal(row[half:], b[half:])


def test_kernel_wrappers_refuse_what_they_cannot_take():
    inputs = _kernel_inputs()
    theta, v, grad, minv = (torch.tensor(inputs[k])
                            for k in ("theta", "v", "grad", "minv"))
    # B7 takes a (1, P) mask row (the packed driver's); any other shape
    # raises JAX's ValueError, and the other slim kernels refuse a mask
    with pytest.raises(ValueError, match="mask must be"):
        su.slim_sghmc_update(theta, v, grad, minv, torch.ones(P), 0.01, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        su.slim_sgld_update(theta, grad, minv, torch.ones(1, P), 0.01, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        su.slim_sghmc_update(theta, v.half(), grad, minv, None, 0.01, 0)
    with pytest.raises(ValueError, match="match theta"):
        su.slim_sgld_update(theta, grad[:, :3], minv, None, 0.01, 0)
    with pytest.raises(ValueError, match="one entry per chain"):
        su.slim_sgld_update(theta, grad, minv, None, torch.ones(3), 0)
    with pytest.raises(ValueError, match="noise"):
        su.slim_sgld_update(theta, grad, minv, None, 0.01, 0,
                            noise=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="seed"):
        su.slim_sgld_update(theta, grad, minv, None, 0.01, -1)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        su.slim_sgld_update(theta.to("meta"), grad.to("meta"),
                            minv.to("meta"), None, 0.01, 0)
    launches = su.slim_sgld_update.launches
    su.slim_sgld_update(theta, grad, minv, None, 0.01, 0)
    assert su.slim_sgld_update.launches == launches  # plain version: no launch


#  Layout ---------------------------------------------------------------------

@pytest.mark.parametrize("network", [default_network, dense_network])
def test_pack_unpack_round_trip(network):
    init, _ = network(1, units=(6, 5), device="cpu")
    params = init(torch.Generator().manual_seed(0), (3,))
    spec = make_lanes_spec({k: leaf[0] for k, leaf in params.items()})
    assert spec.names == tuple(params) and spec.width == 6 + 6 + 30 + 5 + 5 + 1 + 1
    flat = pack_lanes(spec, params)
    assert flat.shape == (3, spec.width) and flat.is_contiguous()
    # the spec fixes the order, not the dict handed in (JAX's is sorted)
    assert torch.equal(pack_lanes(spec, dict(sorted(params.items()))), flat)
    back = unpack_lanes(spec, flat)
    assert list(back) == list(params)
    for key, leaf in params.items():
        assert torch.equal(back[key], leaf), key
    with pytest.raises(ValueError, match="spec wants"):
        pack_lanes(spec, dict(params, b1=params["b1"][:, :2]))


def test_dense_lanes_layout_is_the_fused_layout():
    """Packed in dict order, the dense network and the reference network
    both give the fused kernels' flat vector (same windows and normals)."""
    gen = [torch.Generator().manual_seed(0) for _ in range(2)]
    dense = dense_network(1, units=(7, 7, 7), device="cpu")[0](gen[0], (2,))
    ref = default_network(1, units=(7, 7, 7), device="cpu")[0](gen[1], (2,))
    want = fs.pack(dense, fs.FusedLayout(1, 7, 3))
    for params in (dense, ref):
        spec = make_lanes_spec({k: leaf[0] for k, leaf in params.items()})
        assert torch.equal(pack_lanes(spec, params), want)


def test_batch_fn_draws_the_fused_windows():
    x = torch.linspace(0.0, 1.0, 30)[:, None]
    y = torch.sin(x[:, 0])
    select = batch_fn(x, y, batch_size=6)
    xb, yb = select(11, 5, 4)
    x_win, y_win = fs.data_windows(x, y, 6)
    widx = fs.philox_windows(11, 5, 4, x_win.shape[0], "cpu")
    assert torch.equal(xb[:, :, 0], x_win[widx])
    assert torch.equal(yb[:, :, 0], y_win[widx])


def test_batch_fn_shrinks_the_batch_like_jax(caplog):
    from pysgmcmc_tpu.data_batches import batch_fn as jax_batch_fn

    x = np.arange(5.0, dtype=np.float32)[:, None]
    with caplog.at_level(logging.ERROR):
        xb, yb = batch_fn(x, x[:, 0], batch_size=8)(None, 0, 2)
        jax_xb, _ = jax_batch_fn(x, x[:, 0], batch_size=8)(
            jax.random.PRNGKey(0))
    assert xb.shape == (2,) + jax_xb.shape and yb.shape == (2, 5, 1)
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == 2 and messages[0] == messages[1]


#  The drivers against JAX's interpret-mode drivers ----------------------------

# f32 on both sides, autograd on both: what differs is summation order
# (XLA vs ATen) in the forward and backward passes, carried through 16
# steps; the smallest gradients, which set the largest minv, keep the least
# of it.  Measured, of each leaf's largest |value|: positions 2.5e-7
# (SGHMC) and 4.8e-6 (SGLD), minv 1.6e-6 and 1.9e-6, costs 1.5e-7 and
# 5.1e-7.  SGLD runs at eps 1e-3: it moves theta by eps * minv * g, and at
# 0.01 this path amplifies the same differences to 1.4e-5.  The bound is
# about four times the largest.
DRIVER_RTOL = 2e-5
DRIVER_DATA = 100


def _driver_setup(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1.0, (DRIVER_DATA, 1)).astype(np.float32)
    y = np.sinc(10.0 * x - 5.0).astype(np.float32)
    init, apply = jax_default(1, units=(8, 8))
    positions = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(seed),
                                                N_CHAINS))
    return x, y, apply, positions


def _jax_cost(apply, x, y):
    bnn = JaxBNN(batch_size=DRIVER_DATA)
    return lambda params: bnn.negative_log_likelihood(
        apply, params, x, y, DRIVER_DATA)[0]


def _port_cost(x, y):
    bnn = BayesianNeuralNetwork(batch_size=DRIVER_DATA, step_impl="lanes",
                                device="cpu")
    _, apply = default_network(1, units=(8, 8), device="cpu")
    xt, yt = torch.tensor(x), torch.tensor(y)
    return lambda params: bnn.negative_log_likelihood(
        apply, params, xt, yt, DRIVER_DATA)[0]


@pytest.mark.parametrize("method,eps", [("SGHMC", 0.01), ("SGLD", 1e-3)])
def test_lanes_drivers_match_jax_interpret(method, eps):
    x, y, apply, positions = _driver_setup()
    kw = dict(stepsize_schedule=eps, scale_grad=float(DRIVER_DATA),
              burn_in_steps=8)
    jax_cls, port_cls = ((JaxSGHMC, SGHMCSampler) if method == "SGHMC"
                         else (JaxSGLD, SGLDSampler))
    jax_sampler = jax_cls(_jax_cost(apply, x, y), **kw)
    states = jax.vmap(jax_sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(1), N_CHAINS))
    drive = dict(batch_fn=None, compute_dtype=None, backend="pallas",
                 interpret=True)
    burned = jpacked.burnin_chain_lanes(jax_sampler, states,
                                        jax.random.PRNGKey(2), 8, **drive)
    want_states, want_pos, want_costs = jpacked.sample_chain_lanes(
        jax_sampler, burned, jax.random.PRNGKey(3), 2, keep_every=4, **drive)

    sampler = port_cls(_port_cost(x, y), **kw)
    gen = torch.Generator().manual_seed(0)
    port_states = sampler.init(interop.params_from_numpy(positions, "cpu"))
    port_burned = burnin_chain_lanes(sampler, port_states, gen, 8,
                                     compute_dtype=None, noise_impl="zero")
    got_states, got_pos, got_costs = sample_chain_lanes(
        sampler, port_burned, gen, 2, keep_every=4, compute_dtype=None,
        noise_impl="zero")

    assert int(got_states.step) == int(want_states.step[0]) == 16
    for name, want in (("minv", burned.stats.minv),
                       ("position", want_pos)):
        got = port_burned.stats.minv if name == "minv" else got_pos
        for key, leaf in want.items():
            leaf = np.asarray(leaf)
            assert got[key].shape == leaf.shape, (name, key)
            scale = np.abs(leaf).max()
            np.testing.assert_allclose(got[key].numpy(), leaf, rtol=0,
                                       atol=DRIVER_RTOL * scale,
                                       err_msg="{} {}".format(name, key))
    np.testing.assert_allclose(got_costs.numpy(), np.asarray(want_costs),
                               rtol=DRIVER_RTOL)
    if method == "SGHMC":
        for key, leaf in want_states.momentum.items():
            np.testing.assert_allclose(
                got_states.momentum[key].numpy(), np.asarray(leaf), rtol=0,
                atol=DRIVER_RTOL * np.abs(np.asarray(leaf)).max(),
                err_msg=key)


def _small_sampler(cls=SGHMCSampler, schedule=0.01):
    x, y, _, _ = _driver_setup()
    return cls(_port_cost(x, y), stepsize_schedule=schedule,
               scale_grad=float(DRIVER_DATA))


def _small_states(sampler, n=4):
    init, _ = default_network(1, units=(8, 8), device="cpu")
    return sampler.init(init(torch.Generator().manual_seed(0), (n,)))


def test_lanes_drivers_shapes_and_bookkeeping():
    """burn-in hands the final minv to the sampling phase; positions and
    costs are shaped as in the JAX drivers; unported options raise."""
    sampler = _small_sampler()
    states = _small_states(sampler)
    gen = torch.Generator().manual_seed(0)
    burned = burnin_chain_lanes(sampler, states, gen, 5)
    assert int(burned.step) == 5
    assert list(burned.position) == list(states.position)
    for leaf in burned.stats.minv.values():
        assert torch.isfinite(leaf).all() and (leaf > 0).all()
    assert burnin_chain_lanes(sampler, burned, gen, 0) is burned
    out, pos, costs = sample_chain_lanes(sampler, burned, gen, 2,
                                         keep_every=3)
    assert int(out.step) == 11
    assert costs.shape == (4, 2) and torch.isfinite(costs).all()
    assert pos["w2"].shape == (4, 2, 8, 8) and pos["w1"].shape == (4, 2, 1, 8)
    assert torch.equal(pos["w2"][:, -1], out.position["w2"])
    assert out.stats is burned.stats  # frozen in the sampling phase
    _, none, _ = sample_chain_lanes(sampler, burned, gen, 1,
                                    collect_positions=False)
    assert none is None
    unported = type("SVGDSampler", (), {})()
    for kwargs, match in ((dict(), "BayesianNeuralNetwork's SVGD path"),):
        with pytest.raises(NotImplementedError, match=match):
            sample_chain_lanes(unported, burned, gen, 1, **kwargs)
    for kwargs in (dict(compute_dtype=torch.float16),
                   dict(state_dtype=torch.float16)):
        with pytest.raises(ValueError, match="torch.bfloat16"):
            burnin_chain_lanes(sampler, states, gen, 1, **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        burnin_chain_lanes(sampler, states, gen, 1, mesh=object())


@pytest.mark.parametrize("cls", [SGHMCSampler, SGLDSampler])
def test_per_chain_stepsizes_in_the_drivers(cls):
    """A stacked TracedStepsizeSchedule state runs every chain at its own
    stepsize: chain for chain, the runs at the two scalar stepsizes."""
    def run(schedule_state):
        sampler = _small_sampler(cls, TracedStepsizeSchedule(EPS_A))
        states = _small_states(sampler)._replace(
            schedule_state=schedule_state)
        gen = torch.Generator().manual_seed(4)
        burned = burnin_chain_lanes(sampler, states, gen, 3)
        return sample_chain_lanes(sampler, burned, gen, 1, keep_every=2)[1]

    row = run(torch.tensor([EPS_A, EPS_A, EPS_B, EPS_B]))
    runs = [run(torch.tensor(eps)) for eps in (EPS_A, EPS_B)]
    for key, leaf in row.items():
        assert torch.equal(leaf[:2], runs[0][key][:2]), key
        assert torch.equal(leaf[2:], runs[1][key][2:]), key
        assert not torch.equal(runs[0][key], runs[1][key]), key


#  The lanes BNN ------------------------------------------------------------------

SLICE = dict(step_impl="lanes", n_chains=2, n_nets=4, burn_in_steps=8,
             sample_steps=4, n_iters=16, log_every=None, noise_impl="zero")
# Lanes against fused on the dense network, degenerate stream: the lanes
# path differentiates the whole cost by autograd (weight prior included),
# the fused plain version has its own backward pass and folds the prior
# into the update.  Measured after 16 steps, of the largest |sample|:
# SGHMC 2.1e-8 (scale 6.3), SGLD 1.9e-7 (scale 2.5); the bounds are about
# ten times that.
LANES_FUSED_RTOL = {"SGHMC": 2e-7, "SGLD": 2e-6}
# reference vs dense on lanes: the same flat vectors, the first layer and
# the head by (1, H) and (H, 1) products instead of a broadcast multiply
# and a matrix-vector product.  Measured 4.7e-9 (SGHMC) and 4.7e-8 (SGLD).
REF_DENSE_RTOL = 5e-7


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    return x, np.sinc(x[:, 0] * 10 - 5)


def _train(**kwargs):
    bnn = BayesianNeuralNetwork(device="cpu", **kwargs)
    bnn.train(*_data())
    return bnn


def _flat(samples):
    return torch.cat([samples[k].reshape(len(samples[k]), -1)
                      for k in samples], dim=1)


@pytest.mark.parametrize("method", ["SGHMC", "SGLD"])
def test_lanes_bnn_matches_fused_bnn_on_dense(method):
    kw = dict(SLICE, sampling_method=Sampler[method], network="dense")
    lanes = _train(**kw)
    fused = _train(**dict(kw, step_impl="fused"))
    assert list(lanes.samples) == list(fused.samples)
    got, want = _flat(lanes.samples), _flat(fused.samples)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= LANES_FUSED_RTOL[method], err


@pytest.mark.parametrize("method", ["SGHMC", "SGLD"])
def test_reference_network_matches_dense_on_lanes(method):
    kw = dict(SLICE, sampling_method=Sampler[method])
    ref = _train(network="reference", **kw)
    dense = _train(network="dense", **kw)
    assert ref.samples["w1"].shape == (4, 1, 50)
    assert ref.samples["w4"].shape == (4, 50, 1)
    got, want = _flat(ref.samples), _flat(dense.samples)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= REF_DENSE_RTOL, err
    x_grid = np.linspace(0.0, 1.0, 9)[:, None]
    for a, b in zip(ref.predict(x_grid), dense.predict(x_grid)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_lanes_log_every_segments_match_one_segment(caplog):
    whole = _train(network="reference", **SLICE)
    with caplog.at_level(logging.INFO):
        chunked = _train(network="reference", **dict(SLICE, log_every=3))
    for key, leaf in whole.samples.items():
        assert torch.equal(leaf, chunked.samples[key]), key
    lines = [r.getMessage() for r in caplog.records if "NLL" in r.getMessage()]
    assert len(lines) == 1 + 3 + 2 and "Samples = 4" in lines[-1]


@pytest.mark.parametrize("method", ["SGHMC", "SGLD"])
def test_lanes_bnn_learns_sinc(method):
    bnn = _train(sampling_method=Sampler[method], network="reference",
                 step_impl="lanes", units=(16, 16), n_chains=4, n_nets=8,
                 burn_in_steps=300, sample_steps=10, n_iters=320)
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    mean, var = bnn.predict(x_grid)
    assert mean.shape == var.shape == (50,)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    truth = np.sinc(x_grid[:, 0] * 10 - 5)
    assert np.mean((mean - truth) ** 2) < 0.1
    assert set(bnn.phase_seconds) == {"burn_in", "sampling"}


def test_lanes_bnn_takes_a_user_network():
    """``get_net``: any ``(init, apply)`` pair with the default network's
    contract trains on the lanes path."""
    init, apply = default_network(1, units=(5,), device="cpu")
    bnn = _train(get_net=(init, apply), **SLICE)
    assert bnn.samples["w1"].shape == (4, 1, 5)
    assert bnn.predict(np.linspace(0.0, 1.0, 3)[:, None])[0].shape == (3,)
