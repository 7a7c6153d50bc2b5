"""The one-step fused kernels of the PyTorch port, B3 (``fused_bnn_step``)
and B4-sgld (``fused_bnn_step_sgld``), and the one-step chain driver
(``sample_chain_fused(multistep=False)``, also for pSGLD, SGNHT and
relativistic SGHMC), against the JAX package.

These kernels take injected noise and a pre-gathered minibatch, so they are
the exact oracle for the update rules against JAX:

(a) their plain versions against the JAX Pallas kernels in interpret mode on
    the same ``noise=`` and gathered windows (JAX's own bounds: its tests'
    bf16 MXU slack);
(b) against one step of JAX's per-step sampler with the same noise, f32 on
    both sides;
(c) the driver: k one-step launches on the windows ``philox_windows`` draws
    equal one multi-step launch of k steps from the same state and seed.
"""

import jax
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats as JaxStats
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler as JaxSGHMC
from pysgmcmc_tpu.samplers.sgld import SGLDSampler as JaxSGLD
from pysgmcmc_tpu_torch.models import dense_network
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.parallel import burnin_chain_fused, sample_chain_fused
from pysgmcmc_tpu_torch.samplers import (
    PSGLDSampler,
    RelativisticSGHMCSampler,
    SGHMCSampler,
    SGLDSampler,
    SGNHTSampler,
)
from tests.test_torch_fused_step import (
    BATCH,
    H,
    MDECAY,
    N_DATA,
    P,
    PRIOR,
    _jax_cost,
    assert_trees_close,
    to_flat,
    to_tree,
    windows,
    workload,
)

# SGLD moves theta by eps * minv * g, SGHMC by eps**2 * minv * g: on these
# unadapted stats B4-sgld at eps = 0.01 moves the head weights by O(1) in one
# step (the JAX test adapts minv first), so it runs at 1e-3.
EPS = {"B3": 0.01, "B4-sgld": 1e-3}
A_COEF = 1.3
WIDX = np.array([0, 3, 80, 41], np.int32)


def _inputs(seed):
    """Four chains, their gathered windows and injected noise, made with
    numpy and handed to both sides."""
    n = WIDX.size
    x, y, st = workload(n, seed=seed)
    xw, yw = windows(x, y)
    x_sel, y_sel = fs.gather_batch(xw, yw, torch.tensor(WIDX))
    noise = np.random.RandomState(seed + 100).standard_normal(
        (n, P)).astype(np.float32)
    return x, y, st, x_sel, y_sel, noise


def _kernel_args(name):
    if name == "B3":
        return dict(mdecay=MDECAY)
    return dict(a_coef=A_COEF)


def _port_step(name, st, x_sel, y_sel, noise, **extra):
    common = dict(scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, noise=torch.tensor(noise),
                  **_kernel_args(name), **extra)
    if name == "B3":
        theta, v, cost = fs.fused_bnn_step_ref(
            to_flat(st["theta"]), to_flat(st["v"]), to_flat(st["minv"]),
            x_sel, y_sel, EPS[name], 0, **common)
        return {"theta": theta, "v": v}, cost
    theta, cost = fs.fused_bnn_step_sgld_ref(
        to_flat(st["theta"]), to_flat(st["minv"]), x_sel, y_sel, EPS[name],
        0, **common)
    return {"theta": theta}, cost


#  (a) against the JAX Pallas kernels in interpret mode ----------------------

# JAX's own bounds for these kernels against its f32 pytree sampler
# (tests/ops/test_fused_step.py:135-141 and :326-329): SGHMC 2e-4 on
# positions and momenta, SGLD 1e-2 on positions.  They absorb the TPU
# kernels' bf16 MXU operands, which the port (f32 throughout) does not share.
# Measured here: 1.7e-4 on B3's theta and v (which move by 5e-2 in this
# step) and 2.2e-3 on B4-sgld's theta (which moves by 0.66); costs 0.4 %.
PALLAS_TOL = {"B3": dict(rtol=0.0, atol=2e-4),
              "B4-sgld": dict(rtol=0.0, atol=1e-2)}


@pytest.mark.parametrize("name", ["B3", "B4-sgld"])
def test_one_step_matches_pallas_kernel(name):
    x, y, st, x_sel, y_sel, noise = _inputs(seed=21)
    n = WIDX.size
    jx_sel, jy_sel = jfs.gather_batch(*jfs.data_windows(x, y, BATCH), WIDX)
    noise_slabs = jfs.pack_fused(to_tree(torch.tensor(noise)))
    common = dict(scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, block_chains=n,
                  noise=noise_slabs, interpret=True)
    if name == "B3":
        theta, v, cost = jfs.fused_bnn_step(
            jfs.pack_fused(st["theta"]), jfs.pack_fused(st["v"]),
            jfs.pack_fused(st["minv"]), jx_sel, jy_sel, EPS[name], 0,
            mdecay=MDECAY, state_dtype=np.float32, **common)
        want = {"theta": theta, "v": v}
    else:
        theta, cost = jfs.fused_bnn_step_sgld(
            jfs.pack_fused(st["theta"]), jfs.pack_fused(st["minv"]), jx_sel,
            jy_sel, EPS[name], 0, a_coef=A_COEF, **common)
        want = {"theta": theta}
    got, got_cost = _port_step(name, st, x_sel, y_sel, noise)
    for key, flat in got.items():
        assert_trees_close(to_tree(flat), jfs.unpack_fused(want[key], H),
                           "{} {}".format(name, key), **PALLAS_TOL[name])
    np.testing.assert_allclose(got_cost.numpy(), np.asarray(cost),
                               rtol=2e-2)


#  (b) against one step of the JAX per-step sampler ---------------------------

# f32 on both sides: only summation order differs (XLA vs torch.bmm,
# autodiff vs the hand-written backward pass), one step.
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["B3", "B4-sgld"])
def test_one_step_matches_per_step_sampler(name):
    x, y, st, x_sel, y_sel, noise = _inputs(seed=22)
    n = WIDX.size
    _, apply_fn = jax_dense(1)
    common = dict(stepsize_schedule=EPS[name], burn_in_steps=0,
                  scale_grad=float(N_DATA), gaussian_prior_scale=PRIOR)
    if name == "B3":
        sampler = JaxSGHMC(_jax_cost(apply_fn), mdecay=MDECAY, **common)
    else:
        sampler = JaxSGLD(_jax_cost(apply_fn), A=A_COEF, **common)
    stats = JaxStats(tau=st["tau"], g=st["g"], v_hat=st["v_hat"],
                     minv=st["minv"])
    state = sampler.init(st["theta"])._replace(stats=stats)
    if name == "B3":
        state = state._replace(momentum=st["v"])
    state = state._replace(step=np.zeros((n,), np.int32))
    eta = to_tree(torch.tensor(noise))
    xb = x_sel.numpy()[:, :, None]
    yb = y_sel.numpy()[:, :, None]
    ref = jax.vmap(lambda s, a, b, e: sampler.step(
        s, jax.random.PRNGKey(0), (a, b), noise=e, phase="sampling")[0])(
            state, xb, yb, eta)

    got, _ = _port_step(name, st, x_sel, y_sel, noise)
    assert_trees_close(to_tree(got["theta"]), ref.position, name + " theta",
                       **STEP_TOL)
    if name == "B3":
        assert_trees_close(to_tree(got["v"]), ref.momentum, name + " v",
                           **STEP_TOL)


#  (c) the one-step driver against the multi-step driver ----------------------

def _driver_setup(sampler_cls, eps, n=3, h=6):
    """The sampler and its states 5 steps in: after a B2 / B6 burn-in for
    SGHMC and SGLD; initial momenta (and the step counter moved on) for the
    samplers without burn-in machinery."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    init, _ = dense_network(1, units=(h, h), device="cpu")
    kw = {} if sampler_cls is RelativisticSGHMCSampler \
        else dict(scale_grad=100.0)
    sampler = sampler_cls(lambda p, b: None, stepsize_schedule=eps,
                          gaussian_prior_scale=1e-3, **kw)
    gen = torch.Generator().manual_seed(0)
    positions = init(gen, (n,))
    if sampler_cls in (SGHMCSampler, SGLDSampler):
        states = burnin_chain_fused(sampler, sampler.init(positions), gen, 5,
                                    x, y)
    else:
        states = sampler.init(positions, gen)
        states = states._replace(step=states.step + 5)
    return sampler, states, x, y


@pytest.mark.parametrize("noise_impl", ["box_muller", "zero"])
@pytest.mark.parametrize("sampler_cls,eps", [
    (SGHMCSampler, 0.01), (SGLDSampler, 1e-3), (PSGLDSampler, 1e-3),
    (SGNHTSampler, 1e-3), (RelativisticSGHMCSampler, 1e-3)])
def test_one_step_driver_equals_multistep_driver(sampler_cls, eps,
                                                 noise_impl):
    """Same state, same generator seed: k launches of B3 / B4-* follow one
    B1 / B5-* launch of k steps bit for bit (the plain versions run the
    same arithmetic on the same Philox windows and noise)."""
    sampler, states, x, y = _driver_setup(sampler_cls, eps)
    runs = [sample_chain_fused(
        sampler, states, torch.Generator().manual_seed(4), 2, x, y,
        keep_every=3, multistep=multistep, noise_impl=noise_impl)
        for multistep in (True, False)]
    (a, pos_a, cost_a), (b, pos_b, cost_b) = runs
    for key in pos_a:
        assert torch.equal(pos_a[key], pos_b[key]), key
        assert torch.equal(a.position[key], b.position[key]), key
    assert torch.equal(cost_a, cost_b)
    assert type(a) is type(b) is type(states)
    for field in ("momentum", "v"):
        if hasattr(a, field):
            for key, leaf in getattr(a, field).items():
                assert torch.equal(leaf, getattr(b, field)[key]), key
    if sampler_cls is SGNHTSampler:
        assert a.xi.shape == (3,) and torch.equal(a.xi, b.xi)


@pytest.mark.parametrize("sampler_cls", [SGHMCSampler, SGLDSampler])
def test_one_step_driver_shapes_and_bookkeeping(sampler_cls):
    sampler, states, x, y = _driver_setup(sampler_cls, 1e-3, n=3, h=6)
    assert int(states.step) == 5
    before = (fs.fused_bnn_step.launches, fs.fused_bnn_step_sgld.launches)
    out, pos, costs = sample_chain_fused(
        sampler, states, torch.Generator().manual_seed(1), 2, x, y,
        keep_every=3)  # multistep=False is the default, as in JAX
    assert int(out.step) == 11
    assert costs.shape == (3, 2) and torch.isfinite(costs).all()
    assert pos["w2"].shape == (3, 2, 6, 6) and pos["w1"].shape == (3, 2, 6)
    assert torch.equal(pos["w2"][:, -1], out.position["w2"])
    assert out.stats is states.stats  # frozen in the sampling phase
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (fs.fused_bnn_step.launches,
            fs.fused_bnn_step_sgld.launches) == before
    _, none, _ = sample_chain_fused(sampler, states, torch.Generator(), 1, x,
                                    y, collect_positions=False)
    assert none is None
    with pytest.raises(ValueError, match="multistep=True"):
        sample_chain_fused(sampler, states, torch.Generator(), 1, x, y,
                           pair_dots=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        sample_chain_fused(sampler, states, torch.Generator(), 1, x, y,
                           mesh=object())


#  The kernels' own contracts --------------------------------------------------

@pytest.mark.parametrize("name", ["B3", "B4-sgld"])
def test_one_step_equals_multistep_kernel_at_one_step(name):
    """The one-step kernels on the Philox windows of step s are the
    multi-step kernels at k_steps = 1, step0 = s, bit for bit."""
    x, y, st, _, _, _ = _inputs(seed=23)
    xw, yw = windows(x, y)
    n, seed, step, eps = WIDX.size, 2**40 + 3, 77, EPS[name]
    x_sel, y_sel = fs.gather_batch(
        xw, yw, fs.philox_windows(seed, step, n, xw.shape[0], "cpu"))
    common = dict(scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, **_kernel_args(name))
    if name == "B3":
        state = [to_flat(st[k]) for k in ("theta", "v", "minv")]
        one = fs.fused_bnn_step(*state, x_sel, y_sel, eps, seed, step=step,
                                **common)
        multi = fs.fused_bnn_multistep(*state, xw, yw, eps, seed,
                                       step0=step, **common)
        # select_in_kernel is B1 at k_steps = 1
        sel = fs.fused_bnn_step(*state, xw, yw, eps, seed, step=step,
                                select_in_kernel=True, **common)
        for a, b in zip(sel, multi):
            assert torch.equal(a, b)
    else:
        state = [to_flat(st[k]) for k in ("theta", "minv")]
        one = fs.fused_bnn_step_sgld(*state, x_sel, y_sel, eps, seed,
                                     step=step, **common)
        multi = fs.fused_bnn_multistep_sgld(*state, xw, yw, eps, seed,
                                            step0=step, **common)
    for a, b in zip(one, multi):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_inputs,batch", [(1, 20), (3, 7)])
def test_gather_batch_matches_jax(n_inputs, batch):
    rng = np.random.RandomState(2)
    x = rng.uniform(size=(60, n_inputs)).astype(np.float32)
    y = rng.standard_normal(60).astype(np.float32)
    widx = rng.randint(0, 60 - batch + 1, 5).astype(np.int32)
    jx, jy = jfs.gather_batch(*jfs.data_windows(x, y, batch), widx)
    tx, ty = fs.gather_batch(*fs.data_windows(torch.tensor(x),
                                              torch.tensor(y), batch),
                             torch.tensor(widx))
    # JAX pads the batch axis to the TPU kernel's 24 rows
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx)[:, :batch])
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy)[:, :batch])
    assert tx.shape == ((5, batch) if n_inputs == 1 else (5, batch, n_inputs))


@pytest.mark.parametrize("bad,error", [
    (dict(n_inputs=2), ValueError),
    (dict(noise=torch.zeros((1, 4, P))), ValueError),
    (dict(batch_size=10), ValueError),
    (dict(noise_impl="hadamard_clt", noise=torch.zeros((WIDX.size, P))),
     ValueError),
    (dict(seed=-1), ValueError),
    (dict(x_sel=torch.zeros((3, BATCH))), ValueError),
])
@pytest.mark.parametrize("name", ["B3", "B4-sgld"])
def test_one_step_wrapper_validation(name, bad, error):
    _, _, st, x_sel, y_sel, _ = _inputs(seed=24)
    kwargs = dict(seed=1, x_sel=x_sel)
    kwargs.update(bad)
    x_sel = kwargs.pop("x_sel")
    with pytest.raises(error):
        if name == "B3":
            fs.fused_bnn_step(to_flat(st["theta"]), to_flat(st["v"]),
                              to_flat(st["minv"]), x_sel, y_sel, 0.01,
                              **kwargs)
        else:
            fs.fused_bnn_step_sgld(to_flat(st["theta"]), to_flat(st["minv"]),
                                   x_sel, y_sel, 0.01, **kwargs)


def test_one_step_refuses_what_jax_refuses():
    _, _, st, x_sel, y_sel, noise = _inputs(seed=25)
    state = [to_flat(st[k]) for k in ("theta", "v", "minv")]
    # JAX's one-step paired kernel draws its own noise
    with pytest.raises(ValueError, match="noise injection"):
        fs.fused_bnn_step(*state, x_sel, y_sel, 0.01, 1, pair_dots=True,
                          noise=torch.tensor(noise))
    # bf16 state wants a bf16 v (JAX refuses an f32 v for its bf16 ref)
    with pytest.raises(ValueError, match="match theta"):
        fs.fused_bnn_step(*state, x_sel, y_sel, 0.01, 1,
                          state_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="select_in_kernel"):
        fs.fused_bnn_step(*state, x_sel, y_sel, 0.01, 1,
                          select_in_kernel=True,
                          noise=torch.tensor(noise))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        meta = torch.empty((WIDX.size, P), device="meta")
        fs.fused_bnn_step_sgld(meta, meta, x_sel, y_sel, 0.01, 1)
