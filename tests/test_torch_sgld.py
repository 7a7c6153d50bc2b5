"""SGLD in the PyTorch port against the JAX package: the per-step
``SGLDSampler``, its factory and state interop, and the plain versions of
kernels B5-sgld (``fused_bnn_multistep_sgld_ref``) and B6
(``fused_bnn_multistep_burnin_sgld_ref``).

The kernels' plain versions are held against k steps of JAX's per-step
``SGLDSampler.step(noise=)`` on the same injected noise and windows (f32 on
both sides), and against the JAX Pallas kernels in interpret mode on their
degenerate stream (zero noise, window 0).  Inputs are made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu import sampling as jax_sampling
from pysgmcmc_tpu.models.bayesian_neural_network import (
    log_variance_prior_log_like as jax_lvp,
)
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats as JaxStats
from pysgmcmc_tpu.samplers.sgld import SGLDSampler as JaxSGLD
from pysgmcmc_tpu_torch import interop, sampling
from pysgmcmc_tpu_torch.models import dense_network, log_variance_prior_log_like
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.samplers import AdaptiveStats, SGLDSampler
from tests.test_torch_fused_step import (
    BATCH,
    H,
    N_DATA,
    P,
    PER_STEP_TOL,
    PRIOR,
    STATS_REL_ATOL,
    _jax_cost,
    _zero_stream,
    assert_trees_close,
    to_flat,
    to_tree,
    windows,
    workload,
)
from tests.test_torch_sghmc import _data, _fused_cost, _jax_params

# SGLD moves theta by eps * minv * g (SGHMC: eps**2 * minv * g).  On the
# unadapted stats of these inputs eps = 0.01 sends the log-variance bias
# to overflow within a few steps, so the kernel tests run at 1e-3.
EPS = 1e-3
A_COEF = 1.3
# Per-step parity of the positions: the gradient term eps * minv * g is
# 10x SGHMC's eps**2 * minv * g at the fused tests' eps = 0.01, and so are
# the summation-order differences it carries into theta; atol 1e-5 instead
# of PER_STEP_TOL's 1e-6, rtol unchanged.
SGLD_STEP_TOL = dict(PER_STEP_TOL, atol=1e-5)


#  The per-step sampler -------------------------------------------------------

@pytest.mark.parametrize("phase", ["burn_in", "sampling"])
def test_sgld_step_matches_jax(phase):
    """Eight SGLD steps with JAX-drawn injected noise, f32 on both sides
    (rtol 1e-4, atol 1e-5: summation order only, carried eight steps)."""
    params, apply = _jax_params(1)
    x, y = _data(1)
    rng = np.random.RandomState(5)

    def like(lo, hi):
        return {k: rng.uniform(lo, hi, np.shape(v)).astype(np.float32)
                for k, v in params.items()}

    stats = dict(tau=like(1.0, 5.0), g=like(-1.0, 1.0),
                 v_hat=like(1.0, 5.0), minv=like(0.2, 1.2))
    keys = iter(jax.random.split(jax.random.PRNGKey(11), 8 * len(params)))
    noises = [{k: np.asarray(jax.random.normal(next(keys), np.shape(v)))
               for k, v in params.items()} for _ in range(8)]
    kwargs = dict(stepsize_schedule=EPS, burn_in_steps=4, A=A_COEF,
                  scale_grad=100.0, gaussian_prior_scale=1e-4)

    jax_sampler = JaxSGLD(_fused_cost(apply, jax_lvp, jnp), **kwargs)
    state = jax_sampler.init(params)._replace(stats=JaxStats(**stats))
    for eta in noises:
        state = jax_sampler.step(state, jax.random.PRNGKey(0), (x, y),
                                 noise=eta, phase=phase)[0]

    _, port_apply = dense_network(1, device="cpu")
    port_sampler = SGLDSampler(
        _fused_cost(port_apply, log_variance_prior_log_like, torch), **kwargs)
    port_state = port_sampler.init(interop.params_from_numpy(params, "cpu"))
    port_state = port_state._replace(stats=AdaptiveStats(
        **{k: interop.params_from_numpy(v, "cpu") for k, v in stats.items()}))
    batch = (torch.tensor(x), torch.tensor(y))
    for eta in noises:
        port_state, info = port_sampler.step(
            port_state, None, batch,
            noise=interop.params_from_numpy(eta, "cpu"), phase=phase)
    assert int(port_state.step) == int(state.step) == 8
    assert float(info.stepsize) == pytest.approx(EPS)
    got = interop.state_to_numpy(port_state)
    assert "momentum" not in got
    for field, want in (("position", state.position),
                        ("tau", state.stats.tau), ("g", state.stats.g),
                        ("v_hat", state.stats.v_hat),
                        ("minv", state.stats.minv)):
        for key in want:
            np.testing.assert_allclose(
                got[field][key], np.asarray(want[key]), rtol=1e-4,
                atol=1e-5, err_msg="{} {} {}".format(phase, field, key))


def test_sgld_step_draws_from_the_generator():
    sampler = SGLDSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
                          stepsize_schedule=0.1)
    state = sampler.init({"x": torch.zeros(3)})
    a = sampler.step(state, torch.Generator().manual_seed(1))[0]
    b = sampler.step(state, torch.Generator().manual_seed(1))[0]
    c = sampler.step(state, torch.Generator().manual_seed(2))[0]
    assert torch.equal(a.position["x"], b.position["x"])
    assert not torch.equal(a.position["x"], c.position["x"])
    # the frozen stats leave the loop state in the sampling phase
    dynamic, frozen = sampler.partition_frozen(a, phase="sampling")
    assert dynamic.stats is None and frozen is a.stats
    assert sampler.merge_frozen(dynamic, frozen) == a
    assert sampler.partition_frozen(a) == (a, None)


def test_sgld_factory_matches_jax():
    sampler = sampling.Sampler.get_sampler(
        sampling.Sampler.SGLD, cost_fn=lambda p: p["x"].sum(), A=2.0)
    want = jax_sampling.Sampler.get_sampler(
        jax_sampling.Sampler.SGLD, cost_fn=lambda p: p["x"].sum(), A=2.0)
    assert type(sampler).__name__ == type(want).__name__ == "SGLDSampler"
    for attr in ("A", "scale_grad", "burn_in_steps", "gaussian_prior_scale"):
        assert getattr(sampler, attr) == getattr(want, attr), attr
    for kwargs in (dict(cost_fn=abs, mdecay=0.05), dict(A=1.0)):
        with pytest.raises(ValueError) as got:
            sampling.Sampler.get_sampler(sampling.Sampler.SGLD, **kwargs)
        with pytest.raises(ValueError) as ref:
            jax_sampling.Sampler.get_sampler(jax_sampling.Sampler.SGLD,
                                             **kwargs)
        assert str(got.value) == str(ref.value)
    assert type(sampling.Sampler.get_sampler(
        sampling.Sampler.SVGD, cost_fn=abs)).__name__ == "SVGDSampler"


def test_sgld_state_from_numpy():
    params, _ = _jax_params(1, units=(4, 4))
    state = JaxSGLD(lambda p: 0.0).init(params)
    port = interop.sgld_state_from_numpy(state, "cpu")
    assert type(port).__name__ == "SGLDState" and int(port.step) == 0
    back = interop.state_to_numpy(port)
    for field in ("tau", "g", "v_hat", "minv"):
        for key, leaf in getattr(state.stats, field).items():
            np.testing.assert_array_equal(back[field][key], np.asarray(leaf))
    for key, leaf in state.position.items():
        np.testing.assert_array_equal(back["position"][key], np.asarray(leaf))


#  B5-sgld and B6 against k steps of the JAX per-step sampler ----------------

def _jax_per_step_sgld(st, x_win, y_win, noise, widx, phase):
    """k steps of the JAX SGLD sampler, each chain on its own window."""
    from pysgmcmc_tpu.models.architectures import dense_network as jax_dense

    _, apply_fn = jax_dense(1)
    sampler = JaxSGLD(_jax_cost(apply_fn), stepsize_schedule=EPS,
                      burn_in_steps=10**6, A=A_COEF,
                      scale_grad=float(N_DATA), gaussian_prior_scale=PRIOR)
    stats = JaxStats(tau=st["tau"], g=st["g"], v_hat=st["v_hat"],
                     minv=st["minv"])
    n = widx.shape[1]
    state = sampler.init(st["theta"])._replace(
        stats=stats, step=jnp.zeros((n,), jnp.int32))
    step = jax.jit(jax.vmap(
        lambda s, xb, yb, eta: sampler.step(
            s, jax.random.PRNGKey(0), (xb, yb), noise=eta, phase=phase)[0]))
    for t in range(widx.shape[0]):
        xb = x_win[widx[t]][:, :, None]
        yb = y_win[widx[t]][:, :, None]
        eta = {k: v[t] for k, v in noise.items()}
        state = step(state, xb, yb, eta)
    return state


@pytest.mark.parametrize("kernel", ["B5-sgld", "B6"])
def test_sgld_kernel_math_matches_per_step_sampler(kernel):
    n, k = 3, 3
    x, y, st = workload(n, seed=12)
    xw, yw = windows(x, y)
    rng = np.random.RandomState(8)
    widx = rng.randint(0, xw.shape[0], (k, n)).astype(np.int32)
    noise_flat = rng.standard_normal((k, n, P)).astype(np.float32)
    noise_tree = {name: np.stack([to_tree(torch.tensor(noise_flat[t]))[name]
                                  for t in range(k)])
                  for name in st["theta"]}
    phase = "burn_in" if kernel == "B6" else "sampling"
    ref = _jax_per_step_sgld(st, xw.numpy(), yw.numpy(), noise_tree, widx,
                             phase)

    common = dict(a_coef=A_COEF, scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, k_steps=k,
                  noise=torch.tensor(noise_flat), widx=torch.tensor(widx))
    if kernel == "B6":
        theta, tau, g, v_hat, minv, _ = fs.fused_bnn_multistep_burnin_sgld_ref(
            *[to_flat(st[name]) for name in ("theta", "tau", "g", "v_hat")],
            xw, yw, EPS, 0, **common)
        for name, flat, want in (("tau", tau, ref.stats.tau),
                                 ("g", g, ref.stats.g),
                                 ("v_hat", v_hat, ref.stats.v_hat),
                                 ("minv", minv, ref.stats.minv)):
            for key, leaf in to_tree(flat).items():
                want_leaf = np.asarray(want[key])
                np.testing.assert_allclose(
                    leaf, want_leaf, rtol=PER_STEP_TOL["rtol"],
                    atol=STATS_REL_ATOL * np.abs(want_leaf).max(),
                    err_msg="B6 {} {}".format(name, key))
    else:
        theta, _ = fs.fused_bnn_multistep_sgld_ref(
            to_flat(st["theta"]), to_flat(st["minv"]), xw, yw, EPS, 0,
            **common)
    assert_trees_close(to_tree(theta), ref.position, kernel + " theta",
                       **SGLD_STEP_TOL)


#  B5-sgld and B6 against the JAX Pallas kernels in interpret mode -----------

# The TPU kernels feed the MXU bf16 operands, and SGLD carries their
# rounding into theta at eps * minv * g: on these unadapted stats eps = 1e-3
# moves the weights by O(1) in three steps, and the bf16 error with them, so
# the interpret-mode comparisons run at eps = 1e-4 (theta moves <= 0.06).
# Measured there (3 steps, zero noise, window 0): theta deviates by 1.4e-4
# (B5-sgld) and 4.9e-4 (B6); B6's tau / g / v_hat / minv by 3.9e-2 relative /
# 0.94 / 1.2e3 / 4.9e-2 relative, inside B2's interpret-mode bounds, which
# they take.  The theta bounds are about twice the measured deviation.
PALLAS_EPS = 1e-4
B5_PALLAS_TOL = {"theta": dict(rtol=0.0, atol=3e-4)}
B6_PALLAS_TOL = {
    "theta": dict(rtol=0.0, atol=1e-3),
    "tau": dict(rtol=1e-1, atol=1e-3),
    "g": dict(rtol=0.5, atol=7.0),
    "v_hat": dict(rtol=0.5, atol=7e3),
    "minv": dict(rtol=1.5e-1, atol=1e-4),
}


def test_sgld_burnin_matches_pallas_kernel():
    """The first test of JAX's B6 (``fused_bnn_multistep_burnin_sgld``)."""
    n, k = 4, 3
    names = ("theta", "tau", "g", "v_hat")
    x, y, st = workload(n, seed=13)
    xw, yw = windows(x, y)
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    out = jfs.fused_bnn_multistep_burnin_sgld(
        *[jfs.pack_fused(st[name]) for name in names], jx_win, jy_win,
        PALLAS_EPS, 0, a_coef=A_COEF, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, block_chains=n, k_steps=k,
        noise_impl="box_muller", interpret=True)
    want = {name: jfs.unpack_fused(o, H) for name, o in zip(
        names + ("minv",), out[:5])}

    noise, widx = _zero_stream(k, n)
    got = fs.fused_bnn_multistep_burnin_sgld_ref(
        *[to_flat(st[name]) for name in names], xw, yw, PALLAS_EPS, 0,
        a_coef=A_COEF, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, k_steps=k, noise=noise, widx=widx)
    for name, flat in zip(names + ("minv",), got[:5]):
        assert_trees_close(to_tree(flat), want[name], "B6 " + name,
                           **B6_PALLAS_TOL[name])
    np.testing.assert_allclose(got[5].numpy(), np.asarray(out[5]),
                               rtol=2e-2, atol=0.0)


def test_sgld_sampling_matches_pallas_kernel():
    n, k = 2, 3
    x, y, st = workload(n, seed=14)
    xw, yw = windows(x, y)
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    theta, cost = jfs.fused_bnn_multistep_sgld(
        jfs.pack_fused(st["theta"]), jfs.pack_fused(st["minv"]), jx_win,
        jy_win, PALLAS_EPS, 0, a_coef=A_COEF, scale_grad=float(N_DATA),
        prior_scale=PRIOR, batch_size=BATCH, n_data=N_DATA, block_chains=n,
        k_steps=k, noise_impl="box_muller", interpret=True)

    noise, widx = _zero_stream(k, n)
    got = fs.fused_bnn_multistep_sgld_ref(
        to_flat(st["theta"]), to_flat(st["minv"]), xw, yw, PALLAS_EPS, 0,
        a_coef=A_COEF, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, k_steps=k, noise=noise, widx=widx)
    assert_trees_close(to_tree(got[0]), jfs.unpack_fused(theta, H),
                       "B5-sgld theta", **B5_PALLAS_TOL["theta"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(cost), rtol=2e-2)


#  Launch chunking and the wrappers --------------------------------------------

@pytest.mark.parametrize("kernel", ["B5-sgld", "B6"])
def test_sgld_chunked_launches_equal_one_launch(kernel):
    n, k = 3, 4
    x, y, st = workload(n, seed=15)
    xw, yw = windows(x, y)
    common = dict(a_coef=A_COEF, scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA)
    seed = 2**41 + 99
    if kernel == "B6":
        fn = fs.fused_bnn_multistep_burnin_sgld
        state = [to_flat(st[name]) for name in ("theta", "tau", "g", "v_hat")]
        n_state = 4
    else:
        fn = fs.fused_bnn_multistep_sgld
        state = [to_flat(st["theta"]), to_flat(st["minv"])]
        n_state = 1
    whole = fn(*state, xw, yw, EPS, seed, k_steps=2 * k, step0=7, **common)
    first = fn(*state, xw, yw, EPS, seed, k_steps=k, step0=7, **common)
    rest = list(first[:n_state]) + state[n_state:]
    second = fn(*rest, xw, yw, EPS, seed, k_steps=k, step0=7 + k, **common)
    for a, b in zip(whole, second):
        assert torch.equal(a, b)
    assert not torch.equal(whole[0], first[0])


@pytest.mark.parametrize("bad,error", [
    (dict(pair_dots=True, noise_impl="hadamard_clt"), ValueError),
    (dict(noise_impl="hadamard_clt", noise=torch.zeros((1, 2, P))),
     ValueError),
    (dict(k_steps=0), ValueError),
    (dict(batch_size=10), ValueError),
    (dict(noise=torch.zeros((1, 2, 7))), ValueError),
])
def test_sgld_wrapper_validation(bad, error):
    x, y, st = workload(2, seed=16)
    xw, yw = windows(x, y)
    kwargs = dict(seed=1, k_steps=1)
    kwargs.update(bad)
    with pytest.raises(error):
        fs.fused_bnn_multistep_sgld(to_flat(st["theta"]), to_flat(st["minv"]),
                                    xw, yw, EPS, **kwargs)
    with pytest.raises(error):
        fs.fused_bnn_multistep_burnin_sgld(
            *[to_flat(st[name]) for name in ("theta", "tau", "g", "v_hat")],
            xw, yw, EPS, **kwargs)
