"""Kernels B1 and B2 of the PyTorch port against the JAX package.

The port's plain versions (``fused_bnn_multistep_ref``,
``fused_bnn_multistep_burnin_ref``) are held against

(a) the JAX Pallas kernels in interpret mode, whose zero-bit PRNG gives
    zero Box-Muller noise and window 0 every step; the port reproduces that
    stream with zero ``noise`` and ``widx``;
(b) k steps of the JAX per-step ``SGHMCSampler.step(noise=)`` on the same
    injected noise and windows, f32 on both sides;
(c) themselves: one launch of 2k steps equals two launches of k under the
    Philox stream, bit for bit.

Inputs are made with numpy and handed to both sides.  The CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.diagnostics.objective_functions import sinc as jax_sinc
from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.models.bayesian_neural_network import (
    log_variance_prior_log_like as jax_lvp,
)
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats as JaxStats
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler as JaxSGHMC
from pysgmcmc_tpu_torch.ops import fused_step as fs

H, N_DATA, BATCH, EPS, MDECAY = 50, 100, 20, 0.01, 0.05
LAYOUT = fs.FusedLayout(1, H, 3)
P = LAYOUT.n_params
PRIOR = 1.0 / (P * N_DATA)
NAMES = ("theta", "v", "tau", "g", "v_hat")


def workload(n, seed=0):
    """Numpy inputs shared by both sides: data, JAX-initialised weights
    (jittered per chain) and adaptation state in the EMAs' stable range."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1.0, (N_DATA, 1)).astype(np.float32)
    y = np.asarray(jax_sinc(x), np.float32)
    init, _ = jax_dense(1)
    params = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(seed), n))
    theta = {k: np.asarray(v) + 0.01 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in params.items()}

    def like(lo, hi):
        return {k: rng.uniform(lo, hi, v.shape).astype(np.float32)
                for k, v in theta.items()}

    state = {"theta": theta, "v": like(-1e-3, 1e-3), "tau": like(1.0, 5.0),
             "g": like(-1.0, 1.0), "v_hat": like(1.0, 5.0),
             "minv": like(0.2, 1.2)}
    return x, y, state


def to_flat(tree):
    return fs.pack({k: torch.tensor(v) for k, v in tree.items()}, LAYOUT)


def to_tree(flat):
    return {k: v.numpy() for k, v in fs.unpack(flat, LAYOUT).items()}


def windows(x, y):
    return fs.data_windows(torch.tensor(x), torch.tensor(y), BATCH)


def assert_trees_close(got, want, label, **tol):
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg="{} {}".format(label, key), **tol)


#  (a) against the JAX Pallas kernels in interpret mode ----------------------

# The JAX kernels' own interpret-mode tolerances (tests/ops/
# test_fused_step.py:919-926 and :1216-1233): they absorb the TPU kernel's
# bf16 MXU operands, which the port (f32 throughout) does not share.
B2_PALLAS_TOL = {
    "theta": dict(rtol=0.0, atol=1.5e-3),
    "v": dict(rtol=0.0, atol=1.5e-3),
    "tau": dict(rtol=1e-1, atol=1e-3),
    "g": dict(rtol=0.5, atol=7.0),
    "v_hat": dict(rtol=0.5, atol=7e3),
    "minv": dict(rtol=1.5e-1, atol=1e-4),
}
B1_PALLAS_TOL = {
    "theta": dict(rtol=0.0, atol=2e-3),
    "v": dict(rtol=1e-2, atol=2e-3),
}


def _zero_stream(k, n):
    return (torch.zeros((k, n, P), dtype=torch.float32),
            torch.zeros((k, n), dtype=torch.int32))


def test_burnin_matches_pallas_kernel():
    n, k = 4, 3
    x, y, st = workload(n)
    xw, yw = windows(x, y)
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    packed = [jfs.pack_fused(st[name]) for name in NAMES]
    out = jfs.fused_bnn_multistep_burnin(
        *packed, jx_win, jy_win, EPS, 0, mdecay=MDECAY,
        scale_grad=float(N_DATA), prior_scale=PRIOR, batch_size=BATCH,
        n_data=N_DATA, block_chains=n, state_dtype=jnp.float32, k_steps=k,
        noise_impl="box_muller", interpret=True)
    want = {name: jfs.unpack_fused(o, H) for name, o in zip(
        NAMES + ("minv",), out[:6])}

    noise, widx = _zero_stream(k, n)
    got = fs.fused_bnn_multistep_burnin_ref(
        *[to_flat(st[name]) for name in NAMES], xw, yw, EPS, 0,
        mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, k_steps=k, noise=noise, widx=widx)
    for name, flat in zip(NAMES + ("minv",), got[:6]):
        assert_trees_close(to_tree(flat), want[name], "B2 " + name,
                           **B2_PALLAS_TOL[name])
    # the Pallas kernel writes its cost into the slab's last vector row
    np.testing.assert_allclose(got[6].numpy(), np.asarray(out[6]),
                               rtol=2e-2, atol=0.0)


def test_sampling_matches_pallas_kernel():
    n, k = 2, 3
    x, y, st = workload(n, seed=1)
    xw, yw = windows(x, y)
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    theta, v, cost = jfs.fused_bnn_multistep(
        jfs.pack_fused(st["theta"]), jfs.pack_fused(st["v"]),
        jfs.pack_fused(st["minv"]), jx_win, jy_win, EPS, 0, mdecay=MDECAY,
        scale_grad=float(N_DATA), prior_scale=PRIOR, batch_size=BATCH,
        n_data=N_DATA, block_chains=n, state_dtype=jnp.float32, k_steps=k,
        noise_impl="box_muller", interpret=True)

    noise, widx = _zero_stream(k, n)
    got = fs.fused_bnn_multistep_ref(
        to_flat(st["theta"]), to_flat(st["v"]), to_flat(st["minv"]), xw, yw,
        EPS, 0, mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, k_steps=k, noise=noise, widx=widx)
    assert_trees_close(to_tree(got[0]), jfs.unpack_fused(theta, H),
                       "B1 theta", **B1_PALLAS_TOL["theta"])
    assert_trees_close(to_tree(got[1]), jfs.unpack_fused(v, H), "B1 v",
                       **B1_PALLAS_TOL["v"])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(cost), rtol=2e-2)


#  (b) against k steps of the JAX per-step sampler ---------------------------

def _jax_cost(apply_fn):
    def cost(params, batch):
        xb, yb = batch
        out = apply_fn(params, xb)
        f_mean, f_log_var = out[:, 0:1], out[:, 1:2]
        mse = jnp.square(yb - f_mean)
        ll = jnp.sum(jnp.sum(
            -mse * (0.5 / (jnp.exp(f_log_var) + 1e-16)) - 0.5 * f_log_var,
            axis=1)) / BATCH
        return -(ll + jax_lvp(f_log_var) / N_DATA)
    return cost


def _jax_per_step(st, x_win, y_win, noise, widx, phase):
    """k steps of the JAX SGHMC sampler, each chain on its own window."""
    _, apply_fn = jax_dense(1)
    sampler = JaxSGHMC(_jax_cost(apply_fn), stepsize_schedule=EPS,
                       burn_in_steps=10**6, mdecay=MDECAY,
                       scale_grad=float(N_DATA), gaussian_prior_scale=PRIOR)
    stats = JaxStats(tau=st["tau"], g=st["g"], v_hat=st["v_hat"],
                     minv=st["minv"])
    state = sampler.init(st["theta"])._replace(
        momentum=st["v"], stats=stats)
    n = widx.shape[1]
    state = state._replace(step=jnp.zeros((n,), jnp.int32))
    step = jax.jit(jax.vmap(
        lambda s, xb, yb, eta: sampler.step(
            s, jax.random.PRNGKey(0), (xb, yb), noise=eta, phase=phase)[0]))
    for t in range(widx.shape[0]):
        xb = x_win[widx[t]][:, :, None]
        yb = y_win[widx[t]][:, :, None]
        eta = {k: v[t] for k, v in noise.items()}
        state = step(state, xb, yb, eta)
    return state


# Both sides compute in f32; they differ only in summation order (XLA dot
# vs torch.bmm, autodiff vs the hand-written backward pass), a few ulp per
# step carried through k = 3 steps.  The EMA statistics add gradients whose
# scale reaches 1e2-1e3 (the log-variance terms): their absolute slack is a
# 1e-5 fraction of each leaf's scale, so an entry that nearly cancels is
# not held to a relative bound its inputs cannot meet.
PER_STEP_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_REL_ATOL = 1e-5


@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_kernel_math_matches_per_step_sampler(kernel):
    n, k = 3, 3
    x, y, st = workload(n, seed=2)
    xw, yw = windows(x, y)
    rng = np.random.RandomState(7)
    widx = rng.randint(0, xw.shape[0], (k, n)).astype(np.int32)
    noise_flat = rng.standard_normal((k, n, P)).astype(np.float32)
    noise_tree = {name: np.stack([to_tree(torch.tensor(noise_flat[t]))[name]
                                  for t in range(k)])
                  for name in st["theta"]}
    phase = "burn_in" if kernel == "B2" else "sampling"
    ref = _jax_per_step(st, xw.numpy(), yw.numpy(), noise_tree, widx, phase)

    common = dict(mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, k_steps=k,
                  noise=torch.tensor(noise_flat), widx=torch.tensor(widx))
    if kernel == "B2":
        theta, v, tau, g, v_hat, minv, _ = fs.fused_bnn_multistep_burnin_ref(
            *[to_flat(st[name]) for name in NAMES], xw, yw, EPS, 0, **common)
        for name, flat, want in (("tau", tau, ref.stats.tau),
                                 ("g", g, ref.stats.g),
                                 ("v_hat", v_hat, ref.stats.v_hat),
                                 ("minv", minv, ref.stats.minv)):
            for key, leaf in to_tree(flat).items():
                want_leaf = np.asarray(want[key])
                np.testing.assert_allclose(
                    leaf, want_leaf, rtol=PER_STEP_TOL["rtol"],
                    atol=STATS_REL_ATOL * np.abs(want_leaf).max(),
                    err_msg="B2 {} {}".format(name, key))
    else:
        theta, v, _ = fs.fused_bnn_multistep_ref(
            to_flat(st["theta"]), to_flat(st["v"]), to_flat(st["minv"]),
            xw, yw, EPS, 0, **common)
    assert_trees_close(to_tree(theta), ref.position, kernel + " theta",
                       **PER_STEP_TOL)
    assert_trees_close(to_tree(v), ref.momentum, kernel + " v",
                       **PER_STEP_TOL)


#  (c) launch chunking under the Philox stream --------------------------------

@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_chunked_launches_equal_one_launch(kernel):
    n, k = 3, 4
    x, y, st = workload(n, seed=3)
    xw, yw = windows(x, y)
    common = dict(mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA)
    seed = 2**40 + 12345
    if kernel == "B2":
        fn = fs.fused_bnn_multistep_burnin
        state = [to_flat(st[name]) for name in NAMES]
        n_state = 5
    else:
        fn = fs.fused_bnn_multistep
        state = [to_flat(st["theta"]), to_flat(st["v"]), to_flat(st["minv"])]
        n_state = 2
    whole = fn(*state, xw, yw, EPS, seed, k_steps=2 * k, step0=100, **common)
    first = fn(*state, xw, yw, EPS, seed, k_steps=k, step0=100, **common)
    rest = list(first[:n_state]) + state[n_state:]
    second = fn(*rest, xw, yw, EPS, seed, k_steps=k, step0=100 + k, **common)
    for a, b in zip(whole, second):
        assert torch.equal(a, b)
    assert not torch.equal(whole[0], first[0])


#  The stream, the layout and the wrappers ------------------------------------

def test_philox_stream_is_chain_and_step_keyed():
    """A chain's draws depend on (seed, chain, step) only: a prefix of the
    chains sees the same windows and noise at any chain count."""
    w8 = fs.philox_windows(5, 17, 8, 81, "cpu")
    w3 = fs.philox_windows(5, 17, 3, 81, "cpu")
    assert torch.equal(w8[:3], w3)
    assert int(w8.min()) >= 0 and int(w8.max()) < 81
    z8 = fs.philox_normals(5, 17, 8, 40, "cpu")
    assert torch.equal(z8[:3, :10], fs.philox_normals(5, 17, 3, 10, "cpu"))
    assert not torch.equal(z8, fs.philox_normals(5, 18, 8, 40, "cpu"))
    assert not torch.equal(z8, fs.philox_normals(6, 17, 8, 40, "cpu"))


@pytest.mark.parametrize("n_inputs,depth", [(1, 3), (3, 2), (2, 4)])
def test_pack_unpack_round_trip(n_inputs, depth):
    from pysgmcmc_tpu_torch.models.architectures import dense_network

    init, _ = dense_network(n_inputs, units=(7,) * depth, device="cpu")
    params = init(torch.Generator().manual_seed(0), (2,))
    lay = fs.fused_layout(params)
    assert lay == fs.FusedLayout(n_inputs, 7, depth)
    flat = fs.pack(params, lay)
    assert flat.shape == (2, lay.n_params)
    assert fs.layout_for(lay.n_params, n_inputs, 7) == lay
    for key, leaf in fs.unpack(flat, lay).items():
        assert torch.equal(leaf, params[key]), key


def test_wrappers_refuse_other_devices():
    theta = torch.empty((2, P), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        fs.fused_bnn_multistep(theta, theta, theta, theta, theta, EPS, 1)


def test_wrappers_run_plain_versions_on_cpu():
    n, k = 2, 2
    x, y, st = workload(n, seed=4)
    xw, yw = windows(x, y)
    args = (to_flat(st["theta"]), to_flat(st["v"]), to_flat(st["minv"]), xw,
            yw, EPS, 9)
    before = fs.fused_bnn_multistep.launches
    got = fs.fused_bnn_multistep(*args, k_steps=k)
    want = fs.fused_bnn_multistep_ref(*args, k_steps=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fs.fused_bnn_multistep.launches == before  # no kernel launched
    assert got[2].shape == (n, 1)


@pytest.mark.parametrize("bad,error", [
    # bf16 state wants v in bf16, as JAX's aliased v must be
    (dict(state_dtype=torch.bfloat16), ValueError),
    (dict(state_dtype=torch.float16), ValueError),
    # the paired kernels have Box-Muller only, and the CLT generator no
    # injected noise, as JAX's
    (dict(pair_dots=True, noise_impl="hadamard_clt"), ValueError),
    (dict(noise_impl="hadamard_clt", noise=torch.zeros((1, 2, P))),
     ValueError),
    (dict(noise_impl="clt"), ValueError),
    (dict(k_steps=0), ValueError),
    (dict(batch_size=10), ValueError),
    (dict(h=40), ValueError),
    (dict(widx=torch.full((1, 2), 99, dtype=torch.int32)), ValueError),
    (dict(seed=-1), ValueError),
])
def test_wrapper_validation(bad, error):
    x, y, st = workload(2, seed=5)
    xw, yw = windows(x, y)
    kwargs = dict(seed=1, k_steps=1)
    kwargs.update(bad)
    with pytest.raises(error):
        fs.fused_bnn_multistep(to_flat(st["theta"]), to_flat(st["v"]),
                               to_flat(st["minv"]), xw, yw, EPS, **kwargs)
