"""The fused path of pSGLD, SGNHT and relativistic SGHMC in the port against
the JAX package: kernels B4-psgld, B4-sgnht, B4-rsghmc (one step on gathered
rows) and B5-psgld, B5-sgnht, B5-rsghmc (k steps per launch), their branches
of ``sample_chain_fused`` and the fused BNN of the three samplers.

(a) The one-step plain versions against JAX's ``fused_bnn_step_*`` in
    interpret mode on the same gathered windows and injected noise, f32
    state on both sides (the JAX kernels' bf16 matrix operands set the
    bound), and against one step of JAX's per-step sampler, f32 on both
    sides.
(b) The multi-step plain versions against JAX's ``fused_bnn_multistep_*``
    in interpret mode, whose zero PRNG bits give zero noise and window 0:
    the port's zero stream.
(c) The port's ``sample_chain_fused(multistep=True)`` against JAX's in
    interpret mode, and the kernels' own contracts: two launches of k steps
    equal one of 2k on the Philox stream.
(d) The fused BNN against the lanes BNN on the dense network, and a small
    sinc training.

Every input is made with numpy seeds and handed to both sides (JAX's
initial states cross through ``interop``).  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.parallel import packed as jpacked
from pysgmcmc_tpu.samplers.psgld import PSGLDSampler as JaxPSGLD
from pysgmcmc_tpu.samplers.relativistic_sghmc import (
    RelativisticSGHMCSampler as JaxRSGHMC,
)
from pysgmcmc_tpu.samplers.sgnht import SGNHTSampler as JaxSGNHT
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.parallel import sample_chain_fused
from pysgmcmc_tpu_torch.samplers import (
    PSGLDSampler,
    RelativisticSGHMCSampler,
    SGNHTSampler,
)
from pysgmcmc_tpu_torch.sampling import Sampler
from tests.test_torch_fused_step import (
    BATCH,
    H,
    N_DATA,
    P,
    PRIOR,
    _jax_cost,
    assert_trees_close,
    to_flat,
    to_tree,
    windows,
)
from tests.test_torch_lanes import SLICE, _flat, _train
from tests.test_torch_one_step import WIDX, _inputs

# sampler -> (rule keywords of the kernels, stepsize of the kernel tests);
# constants away from the defaults, so that each one is exercised
RULES = {
    "psgld": (dict(alpha=0.95, lambda_reg=1e-3, scale_grad=float(N_DATA)),
              1e-3),
    "sgnht": (dict(a_diff=1.5, scale_grad=float(N_DATA)), 1e-3),
    "rsghmc": (dict(mass=1.3, speed_of_light=0.7, d_coef=1.2, b_hat=0.1),
               1e-3),
}
KINDS = sorted(RULES)
STEP = {"psgld": (fs.fused_bnn_step_psgld_ref, jfs.fused_bnn_step_psgld),
        "sgnht": (fs.fused_bnn_step_sgnht_ref, jfs.fused_bnn_step_sgnht),
        "rsghmc": (fs.fused_bnn_step_rsghmc_ref, jfs.fused_bnn_step_rsghmc)}
MULTI = {"psgld": (fs.fused_bnn_multistep_psgld_ref,
                   jfs.fused_bnn_multistep_psgld),
         "sgnht": (fs.fused_bnn_multistep_sgnht_ref,
                   jfs.fused_bnn_multistep_sgnht),
         "rsghmc": (fs.fused_bnn_multistep_rsghmc_ref,
                    jfs.fused_bnn_multistep_rsghmc)}
COMMON = dict(prior_scale=PRIOR, batch_size=BATCH, n_data=N_DATA)


def _state(kind, st, seed):
    """The rule's state beside theta, as numpy: pSGLD's accumulator in the
    range of g^2 of most weights, momenta of order one, one thermostat per
    chain."""
    rng = np.random.RandomState(seed)
    out = {"theta": st["theta"]}
    if kind == "psgld":
        out["v"] = {k: 1e-3 * a for k, a in st["v_hat"].items()}
    else:
        out["v"] = to_tree(torch.tensor(rng.standard_normal(
            (WIDX.size, P)).astype(np.float32)))
    if kind == "sgnht":
        out["xi"] = rng.uniform(0.5, 1.5, WIDX.size).astype(np.float32)
    return out


def _port_args(kind, state):
    args = [to_flat(state["theta"]), to_flat(state["v"])]
    if kind == "sgnht":
        args.append(torch.tensor(state["xi"]))
    return args


def _jax_args(kind, state):
    args = [jfs.pack_fused(state["theta"]), jfs.pack_fused(state["v"])]
    if kind == "sgnht":  # JAX's thermostat rides a replicated lane row
        args.append(jnp.asarray(state["xi"])[:, None]
                    + jnp.zeros((WIDX.size, 128), jnp.float32))
    return args


def _jax_kw(kind):
    kw = dict(RULES[kind][0], block_chains=WIDX.size, interpret=True,
              **COMMON)
    return kw


def _check_states(kind, got, want, tol, label):
    """``got`` (the port's ``(theta, v, [xi,] cost)``) against JAX's;
    ``tol`` holds an absolute bound for theta, v and xi, pSGLD's ``v`` a
    fraction of each leaf's largest |value|."""
    for i, name in enumerate(("theta", "v")):
        want_tree = jfs.unpack_fused(want[i], H)
        if kind == "psgld" and name == "v":
            _leaves_close(to_tree(got[i]), want_tree, tol[name],
                          "{} {}".format(label, name))
            continue
        assert_trees_close(to_tree(got[i]), want_tree,
                           "{} {}".format(label, name), rtol=0,
                           atol=tol[name])
    if kind == "sgnht":
        xi = np.asarray(want[2])
        assert np.all(xi == xi[:, 0:1])
        np.testing.assert_allclose(got[2].numpy(), xi[:, 0], rtol=0,
                                   atol=tol["xi"])
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]),
                               rtol=2e-2)


#  (a) the one-step kernels ---------------------------------------------------

# JAX's own bounds for these kernels against its f32 per-step samplers
# (tests/ops/test_fused_step.py, the pSGLD, SGNHT and relativistic SGHMC
# step tests): 5e-3 on positions and momenta, xi within 1e-4; here pSGLD's
# accumulator within 2 % of each leaf's largest value (JAX: of each value,
# after adapting it for 10 steps, where here g^2 dominates it).  They absorb
# the TPU kernels' bf16 matrix operands, which the port (f32 throughout)
# does not share.  Measured here, largest |port - JAX| in one step: pSGLD
# 1.2e-3 on theta (which moves by up to 4.4e-2) and 3.7e-3 of a leaf's
# scale on v; SGNHT 9.7e-7 on theta and 9.7e-4 on p (which moves by up to
# 0.45); relativistic SGHMC 5.4e-7 and 9.7e-4; xi 0.
PALLAS_TOL = {
    "psgld": dict(theta=5e-3, v=2e-2),
    "sgnht": dict(theta=5e-3, v=5e-3, xi=1e-4),
    "rsghmc": dict(theta=5e-3, v=5e-3),
}


@pytest.mark.parametrize("kind", KINDS)
def test_one_step_matches_pallas_kernel(kind):
    x, y, st, x_sel, y_sel, noise = _inputs(seed=31)
    state = _state(kind, st, seed=32)
    ref, jax_fn = STEP[kind]
    eps = RULES[kind][1]
    jx_sel, jy_sel = jfs.gather_batch(*jfs.data_windows(x, y, BATCH), WIDX)
    want = jax_fn(*_jax_args(kind, state), jx_sel, jy_sel, eps, 0,
                  state_dtype=np.float32, h=H,
                  noise=jfs.pack_fused(to_tree(torch.tensor(noise))),
                  **_jax_kw(kind))
    got = ref(*_port_args(kind, state), x_sel, y_sel, eps, 0,
              noise=torch.tensor(noise), **RULES[kind][0], **COMMON)
    assert len(got) == len(want)
    _check_states(kind, got, want, PALLAS_TOL[kind], kind)


# f32 on both sides: only summation order differs (XLA vs torch.bmm,
# autodiff vs the hand-written backward pass), one step.
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_SAMPLERS = {"psgld": JaxPSGLD, "sgnht": JaxSGNHT, "rsghmc": JaxRSGHMC}


def _jax_sampler(kind, eps):
    kw = dict(RULES[kind][0])
    if kind == "rsghmc":
        kw = dict(mass=kw["mass"], speed_of_light=kw["speed_of_light"],
                  D=kw["d_coef"], Bhat=kw["b_hat"])
    return JAX_SAMPLERS[kind](_jax_cost(jax_dense(1)[1]),
                              stepsize_schedule=eps,
                              gaussian_prior_scale=PRIOR, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_one_step_matches_per_step_sampler(kind):
    x, y, st, x_sel, y_sel, noise = _inputs(seed=33)
    state = _state(kind, st, seed=34)
    eps = RULES[kind][1]
    sampler = _jax_sampler(kind, eps)
    start = sampler.init(state["theta"], jax.random.PRNGKey(0))
    fields = dict(step=np.zeros((WIDX.size,), np.int32))
    fields["v" if kind == "psgld" else "momentum"] = state["v"]
    if kind == "sgnht":
        fields["xi"] = state["xi"]
    start = start._replace(**fields)
    eta = to_tree(torch.tensor(noise))
    xb, yb = x_sel.numpy()[:, :, None], y_sel.numpy()[:, :, None]
    want = jax.vmap(lambda s, a, b, e: sampler.step(
        s, jax.random.PRNGKey(0), (a, b), noise=e)[0])(start, xb, yb, eta)

    got = STEP[kind][0](*_port_args(kind, state), x_sel, y_sel, eps, 0,
                        noise=torch.tensor(noise), **RULES[kind][0], **COMMON)
    assert_trees_close(to_tree(got[0]), want.position, kind + " theta",
                       **STEP_TOL)
    assert_trees_close(to_tree(got[1]),
                       want.v if kind == "psgld" else want.momentum,
                       kind + " v", **STEP_TOL)
    if kind == "sgnht":
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want.xi),
                                   **STEP_TOL)


#  (b) the multi-step kernels on the zero-bit stream --------------------------

# As (a), over K steps on window 0 with zero noise (the JAX kernels'
# interpret stream), with the same bounds.  Measured: pSGLD 5.5e-4 on
# theta and 1.3e-2 of a leaf's scale on v, SGNHT 5.9e-6 on theta and 2.9e-3
# on p, relativistic SGHMC 2.2e-6 and 1.0e-3, xi 0.
K = 3
MULTI_TOL = PALLAS_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_multistep_matches_pallas_kernel_on_zero_stream(kind):
    x, y, st, x_sel, y_sel, _ = _inputs(seed=35)
    state = _state(kind, st, seed=36)
    ref, jax_fn = MULTI[kind]
    eps = RULES[kind][1]
    jx_win, jy_win = jfs.data_windows(x, y, BATCH)
    jax_kw = dict(_jax_kw(kind), k_steps=K, h=H, noise_impl="box_muller")
    if kind != "psgld":  # pSGLD's accumulator is float32 in JAX already
        jax_kw["state_dtype"] = np.float32
    want = jax_fn(*_jax_args(kind, state), jx_win, jy_win, eps, 0, **jax_kw)
    xw, yw = windows(x, y)
    got = ref(*_port_args(kind, state), xw, yw, eps, 0, k_steps=K,
              noise=torch.zeros((K, WIDX.size, P)),
              widx=torch.zeros((K, WIDX.size), dtype=torch.int32),
              **RULES[kind][0], **COMMON)
    assert len(got) == len(want)
    _check_states(kind, got, want, MULTI_TOL[kind], kind)


#  (c) the driver and the kernels' contracts ----------------------------------

DRIVER_H, DRIVER_CHAINS = 8, 4
SAMPLERS = {"psgld": (JaxPSGLD, PSGLDSampler, interop.psgld_state_from_numpy),
            "sgnht": (JaxSGNHT, SGNHTSampler, interop.sgnht_state_from_numpy),
            "rsghmc": (JaxRSGHMC, RelativisticSGHMCSampler,
                       interop.rsghmc_state_from_numpy)}
# The TPU kernels' bf16 matrix operands, carried over 6 steps at width 8, of
# each leaf's largest |value|; pSGLD's preconditioner amplifies them where a
# gradient is near 0.  Measured on positions / accumulator or momentum:
# pSGLD 1.3e-2 / 5.4e-3, SGNHT 8.7e-4 / 1.2e-3, relativistic SGHMC 8.0e-4 /
# 1.0e-3; costs 3.7e-3 (relative, as the kernel tests' 2e-2 bound); xi
# 3.9e-6.
DRIVER_RTOL = {"psgld": 3e-2, "sgnht": 5e-3, "rsghmc": 5e-3}


def _sampler_kw(kind):
    kw = dict(RULES[kind][0], gaussian_prior_scale=1e-3,
              stepsize_schedule=RULES[kind][1])
    if kind == "rsghmc":
        kw.update(D=kw.pop("d_coef"), Bhat=kw.pop("b_hat"))
    return kw


def _leaves_close(got, want, rtol, label):
    for key, leaf in want.items():
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(
            np.asarray(got[key]), leaf, rtol=0,
            atol=rtol * max(np.abs(leaf).max(), 1e-30),
            err_msg="{} {}".format(label, key))


@pytest.mark.parametrize("kind", KINDS)
def test_fused_driver_matches_jax_interpret(kind):
    """2 samples x 3 steps through the multi-step driver, as
    ``tests/ops/test_fused_step.py``'s driver test runs JAX's."""
    jax_cls, port_cls, from_numpy = SAMPLERS[kind]
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (N_DATA, 1)).astype(np.float32)
    y = np.sinc(10.0 * x[:, 0] - 5.0).astype(np.float32)
    init, _ = jax_dense(1, units=(DRIVER_H, DRIVER_H))
    positions = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0),
                                                DRIVER_CHAINS))
    kw = _sampler_kw(kind)
    jax_sampler = jax_cls(lambda p, b: 0.0, **kw)
    states = jax.vmap(jax_sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(1), DRIVER_CHAINS))
    want_states, want_pos, want_costs = jpacked.sample_chain_fused(
        jax_sampler, states, jax.random.PRNGKey(2), 2, x, y, batch_size=BATCH,
        keep_every=3, state_dtype=jnp.float32, multistep=True,
        noise_impl="box_muller", interpret=True)

    sampler = port_cls(lambda p, b: None, **kw)
    start = from_numpy(states, "cpu")._replace(
        schedule_state=sampler.stepsize_schedule.init())
    got_states, got_pos, got_costs = sample_chain_fused(
        sampler, start, torch.Generator().manual_seed(0), 2, x, y,
        batch_size=BATCH, keep_every=3, state_dtype=torch.float32,
        multistep=True, noise_impl="zero")

    assert int(torch.max(got_states.step)) == int(want_states.step[0]) == 6
    for key, leaf in want_pos.items():
        assert got_pos[key].shape == np.shape(leaf), key
    _leaves_close(got_pos, want_pos, DRIVER_RTOL[kind], "positions")
    field = "v" if kind == "psgld" else "momentum"
    _leaves_close(getattr(got_states, field), getattr(want_states, field),
                  DRIVER_RTOL[kind], field)
    if kind == "sgnht":
        assert got_states.xi.shape == (DRIVER_CHAINS,)
        np.testing.assert_allclose(got_states.xi.numpy(),
                                   np.asarray(want_states.xi), rtol=1e-5)
    np.testing.assert_allclose(got_costs.numpy(), np.asarray(want_costs),
                               rtol=2e-2)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_launches_equal_one_launch(kind):
    """Two launches of k steps equal one launch of 2k on the Philox stream,
    bit for bit (the stream is keyed by absolute step)."""
    x, y, st, x_sel, y_sel, _ = _inputs(seed=37)
    xw, yw = windows(x, y)
    fn = {"psgld": fs.fused_bnn_multistep_psgld,
          "sgnht": fs.fused_bnn_multistep_sgnht,
          "rsghmc": fs.fused_bnn_multistep_rsghmc}[kind]
    state = _port_args(kind, _state(kind, st, seed=38))
    kw = dict(RULES[kind][0], **COMMON)
    seed, k = 2**40 + 7, 3
    whole = fn(*state, xw, yw, 1e-3, seed, k_steps=2 * k, step0=50, **kw)
    first = fn(*state, xw, yw, 1e-3, seed, k_steps=k, step0=50, **kw)
    second = fn(*first[:-1], xw, yw, 1e-3, seed, k_steps=k, step0=50 + k,
                **kw)
    for a, b in zip(whole, second):
        assert torch.equal(a, b)
    assert not torch.equal(whole[0], first[0])


def test_sgnht_thermostat_of_k_steps_equals_k_single_steps():
    """One launch of k SGNHT steps moves xi as k launches of one step each,
    bit for bit: each step's thermostat reads that step's p'^T p' alone."""
    x, y, st, _, _, _ = _inputs(seed=41)
    xw, yw = windows(x, y)
    state = _port_args("sgnht", _state("sgnht", st, seed=42))
    kw = dict(RULES["sgnht"][0], **COMMON)
    seed, k = 2**36 + 5, 4
    whole = fs.fused_bnn_multistep_sgnht(*state, xw, yw, 3e-4, seed,
                                         k_steps=k, step0=20, **kw)
    carried = state
    xis = []
    for t in range(k):
        out = fs.fused_bnn_multistep_sgnht(*carried, xw, yw, 3e-4, seed,
                                           k_steps=1, step0=20 + t, **kw)
        carried = out[:-1]
        xis.append(out[2])
    assert torch.equal(whole[2], carried[2])
    for a, b in zip(whole, out):
        assert torch.equal(a, b)
    assert len({tuple(xi.tolist()) for xi in xis}) == k  # xi moves each step


@pytest.mark.parametrize("kind", KINDS)
def test_one_step_kernel_equals_multistep_kernel_at_one_step(kind):
    """The one-step kernels on the Philox windows of step s are the
    multi-step kernels at k_steps = 1, step0 = s, bit for bit; the wrappers
    run the plain versions on CPU tensors and count no launch."""
    x, y, st, x_sel, y_sel, _ = _inputs(seed=39)
    xw, yw = windows(x, y)
    state = _port_args(kind, _state(kind, st, seed=40))
    seed, step = 2**33 + 1, 12
    sel = fs.gather_batch(xw, yw, fs.philox_windows(seed, step, WIDX.size,
                                                    xw.shape[0], "cpu"))
    kw = dict(RULES[kind][0], **COMMON)
    one_fn = {"psgld": fs.fused_bnn_step_psgld,
              "sgnht": fs.fused_bnn_step_sgnht,
              "rsghmc": fs.fused_bnn_step_rsghmc}[kind]
    multi_fn = {"psgld": fs.fused_bnn_multistep_psgld,
                "sgnht": fs.fused_bnn_multistep_sgnht,
                "rsghmc": fs.fused_bnn_multistep_rsghmc}[kind]
    before = (one_fn.launches, multi_fn.launches)
    one = one_fn(*state, *sel, 1e-3, seed, step=step, **kw)
    multi = multi_fn(*state, xw, yw, 1e-3, seed, step0=step, **kw)
    assert (one_fn.launches, multi_fn.launches) == before
    assert len(one) == len(multi) == len(state) + 1
    for a, b in zip(one, multi):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_they_cannot_take():
    x, y, st, x_sel, y_sel, _ = _inputs(seed=41)
    xw, yw = windows(x, y)
    theta, v, xi = _port_args("sgnht", _state("sgnht", st, seed=42))
    for bad in (xi[:2], xi.double(), xi[:, None]):
        with pytest.raises(ValueError, match="xi"):
            fs.fused_bnn_step_sgnht(theta, v, bad, x_sel, y_sel, 1e-3, 0)
        with pytest.raises(ValueError, match="xi"):
            fs.fused_bnn_multistep_sgnht(theta, v, bad, xw, yw, 1e-3, 0)
    with pytest.raises(ValueError, match="match theta"):
        fs.fused_bnn_multistep_rsghmc(theta, v, xw, yw, 1e-3, 0,
                                      state_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="box_muller"):
        fs.fused_bnn_multistep_psgld(theta, v, xw, yw, 1e-3, 0,
                                     pair_dots=True,
                                     noise_impl="hadamard_clt")
    with pytest.raises(ValueError, match="injected noise"):
        fs.fused_bnn_step_psgld(theta, v, x_sel, y_sel, 1e-3, 0,
                                noise_impl="hadamard_clt",
                                noise=torch.zeros_like(theta))
    with pytest.raises(ValueError, match="match theta"):
        fs.fused_bnn_step_rsghmc(theta, v[:, :3], x_sel, y_sel, 1e-3, 0)


#  (d) the fused BNN ----------------------------------------------------------

# Lanes against fused on the dense network, degenerate stream, 8 burn-in and
# 8 sampling steps: the fused BNN burns in on the lanes driver too, so the
# samples differ by the sampling phase alone, where the lanes path
# differentiates the whole cost by autograd (weight prior included) and the
# fused plain version has its own backward pass, folds the prior into the
# update and takes SGNHT's p'^T p' / P as a product with 1 / P.  Measured,
# of the largest |sample| (6.9): pSGLD 1.7e-8, SGNHT 1.3e-10, relativistic
# SGHMC 2.2e-9; the bound is about ten times the largest.
LANES_FUSED_RTOL = 2e-7
BNN_EPS = {"psgld": 1e-4, "sgnht": 3e-4, "rsghmc": 1e-3}
METHODS = {"psgld": "PSGLD", "sgnht": "SGNHT", "rsghmc": "RelativisticSGHMC"}


@pytest.mark.parametrize("kind", KINDS)
def test_fused_bnn_matches_lanes_bnn_on_dense(kind):
    kw = dict(SLICE, sampling_method=Sampler[METHODS[kind]], network="dense",
              stepsize_schedule=BNN_EPS[kind])
    lanes = _train(**kw)
    fused = _train(**dict(kw, step_impl="fused"))
    assert list(lanes.samples) == list(fused.samples)
    got, want = _flat(fused.samples), _flat(lanes.samples)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= LANES_FUSED_RTOL, err


# stepsizes of the lanes BNN's sinc test (tests/test_torch_samplers_lanes.py)
SMALL_TRAIN = {"psgld": 3e-3, "sgnht": 3e-4, "rsghmc": 1e-3}


@pytest.mark.parametrize("kind", KINDS)
def test_fused_bnn_learns_sinc(kind):
    bnn = _train(sampling_method=Sampler[METHODS[kind]], network="dense",
                 step_impl="fused", units=(16, 16), n_chains=4, n_nets=8,
                 burn_in_steps=300, sample_steps=10, n_iters=320,
                 stepsize_schedule=SMALL_TRAIN[kind])
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    mean, var = bnn.predict(x_grid)
    assert mean.shape == var.shape == (50,)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert np.mean((mean - np.sinc(x_grid[:, 0] * 10 - 5)) ** 2) < 0.1
    assert set(bnn.phase_seconds) == {"burn_in", "sampling"}
