"""FusedSGHMC and its kernel B10 in the port against the JAX package.

- B10: the plain version ``fused_sghmc_update_ref`` against JAX's Pallas
  kernel ``fused_sghmc_update`` in interpret mode on the same inputs and
  injected noise, in both phases, within JAX's own bound between the slim
  kernels and their jnp mirror (rtol 1e-6); and over 4 steps that cross the
  burn-in boundary, each package driving its own state with its own
  gradients (``tests/samplers/test_fused.py:28-90``).
- ``FusedSGHMC``: ``pad_dim``, ``init``, ``flatten_positions`` and
  ``unflatten_positions`` exactly (JAX's ravel order sorts the dict's
  keys), and ``run`` on the zero-bit stream (``noise_impl="zero"``; JAX's
  interpret mode reads zero PRNG bits, which Box-Muller turns into zero
  noise) against JAX's interpret-mode ``run`` on the 1x8 reference network
  with a full-data cost, within 2e-5 of each leaf's largest value.
- The state crosses with ``interop.fused_sghmc_state_from_numpy``.

Inputs are made with numpy seeds.  The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import doctest
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.ops import fused_update as jfu
from pysgmcmc_tpu.samplers.fused import FusedSGHMC as JaxFusedSGHMC
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.ops import fused_update as fu
from pysgmcmc_tpu_torch.parallel import packed as packed_module
from pysgmcmc_tpu_torch.samplers import fused as fused_module
from pysgmcmc_tpu_torch.samplers.fused import FusedSGHMC, FusedSGHMCState
from tests import test_torch_lanes as tl

# within 1e-6 of each value and of its output's largest |value| (JAX's
# bound between its slim kernels and their jnp mirror)
KERNEL_RTOL = 1e-6
N, DIM = 8, 256
SCALE_GRAD, MDECAY = 3.0, 0.05


def _close(got, want, rtol, label=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=label)


def _kernel_inputs(seed=0):
    """The seven state operands and a noise array, float32 ``(N, DIM)``,
    in the EMAs' range (one v_hat entry 0, to reach the guards)."""
    rng = np.random.RandomState(seed)

    def arr(lo=None, hi=None):
        if lo is None:
            return rng.standard_normal((N, DIM)).astype(np.float32)
        return rng.uniform(lo, hi, (N, DIM)).astype(np.float32)

    out = {"theta": arr(), "v": 1e-2 * arr(), "tau": arr(1.0, 5.0),
           "g": arr(), "v_hat": arr(0.0, 5.0), "minv": arr(0.1, 2.0),
           "grad": arr(), "noise": arr()}
    out["v_hat"][0, 0] = 0.0
    return out


OPERANDS = ("theta", "v", "tau", "g", "v_hat", "minv", "grad")


@pytest.mark.parametrize("dim", [1, 5, 128, 129, 200, 5252])
def test_pad_dim_matches_jax(dim):
    assert fu.pad_dim(dim) == jfu.pad_dim(dim)
    assert fu.LANES == jfu.LANES


@pytest.mark.parametrize("burning_in", [True, False])
def test_plain_version_matches_pallas_kernel(burning_in):
    inputs = _kernel_inputs()
    want = jfu.fused_sghmc_update(
        *[jnp.asarray(inputs[k]) for k in OPERANDS], 0.05, burning_in, 0,
        mdecay=MDECAY, scale_grad=SCALE_GRAD,
        noise=jnp.asarray(inputs["noise"]), interpret=True)
    got = fu.fused_sghmc_update(
        *[torch.tensor(inputs[k]) for k in OPERANDS], 0.05, burning_in, 7,
        mdecay=MDECAY, scale_grad=SCALE_GRAD,
        noise=torch.tensor(inputs["noise"]))
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32
        _close(a.numpy(), b, KERNEL_RTOL, "output {}".format(i))


def test_phase_flag_selects_the_minv():
    """Burning in, minv_used is 1/sqrt(old v_hat) (guarded); after, the
    given minv; the EMAs move in both phases, identically."""
    inputs = {k: torch.tensor(v) for k, v in _kernel_inputs(1).items()}
    args = [inputs[k] for k in OPERANDS]
    burn = fu.fused_sghmc_update(*args, 0.05, True, 0, noise=inputs["noise"])
    frozen = fu.fused_sghmc_update(*args, 0.05, torch.tensor(False), 0,
                                   noise=inputs["noise"])
    assert torch.equal(frozen[5], inputs["minv"])
    assert torch.equal(burn[5][0, 0], torch.tensor(1e16))  # v_hat 0: guard
    for a, b in zip(burn[2:5], frozen[2:5]):
        assert torch.equal(a, b)


def test_philox_stream_is_keyed_by_seed_and_step():
    inputs = {k: torch.tensor(v) for k, v in _kernel_inputs(2).items()}
    args = [inputs[k] for k in OPERANDS]
    runs = [fu.fused_sghmc_update(*args, 0.05, True, seed, step=step)[1]
            for seed, step in ((5, 3), (5, 3), (5, 4), (6, 3))]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], runs[3])


def test_wrapper_refuses_what_it_cannot_take():
    inputs = {k: torch.tensor(v) for k, v in _kernel_inputs().items()}
    args = [inputs[k] for k in OPERANDS]
    with pytest.raises(ValueError, match="multiple of 128"):
        fu.fused_sghmc_update(*[a[:, :100] for a in args], 0.05, True, 0)
    for i in (1, 5, 6):  # v, minv, grad: float32 only, as JAX's kernel
        bad = list(args)
        bad[i] = bad[i].bfloat16()
        with pytest.raises(ValueError, match="float32"):
            fu.fused_sghmc_update(*bad, 0.05, True, 0)
    with pytest.raises(ValueError, match="scalar"):
        fu.fused_sghmc_update(*args, torch.ones(N), True, 0)
    with pytest.raises(ValueError, match="seed"):
        fu.fused_sghmc_update(*args, 0.05, True, -1)
    launches = fu.fused_sghmc_update.launches
    fu.fused_sghmc_update(*args, 0.05, True, 0)
    assert fu.fused_sghmc_update.launches == launches  # plain: no launch


#  FusedSGHMC -------------------------------------------------------------------

def _jax_quadratic(params):
    return 0.5 * jnp.sum(params["a"] ** 2) + jnp.sum(params["b"] ** 2)


def _port_quadratic(params):
    return 0.5 * torch.sum(params["a"] ** 2) + torch.sum(params["b"] ** 2)


def test_fused_steps_match_jax_across_burn_in():
    """4 steps crossing the burn-in boundary at step 2, JAX's noise injected
    into both kernels, each package stepping its own state with its own
    gradients (``tests/samplers/test_fused.py:28-90``)."""
    n_chains, dim_p = 4, jfu.pad_dim(5)
    rng = np.random.RandomState(0)
    positions = {"a": rng.standard_normal((n_chains, 3)).astype(np.float32),
                 "b": rng.standard_normal((n_chains, 2)).astype(np.float32)}
    kw = dict(stepsize=0.01, burn_in_steps=2, mdecay=MDECAY,
              scale_grad=SCALE_GRAD)
    jax_fused = JaxFusedSGHMC(_jax_quadratic, {"a": jnp.zeros(3),
                                               "b": jnp.zeros(2)},
                              interpret=True, **kw)
    fused = FusedSGHMC(_port_quadratic, {"a": torch.zeros(3),
                                         "b": torch.zeros(2)}, **kw)
    want = jax_fused.init({k: jnp.asarray(v) for k, v in positions.items()})
    got = fused.init(interop.params_from_numpy(positions, "cpu"))
    for step in range(4):
        noise = rng.standard_normal((n_chains, dim_p)).astype(np.float32)
        _, grads = jax_fused._grads(want.theta, None)
        outs = jfu.fused_sghmc_update(
            want.theta, want.momentum, want.tau, want.g, want.v_hat,
            want.minv, grads, 0.01, want.step < 2, 0, mdecay=MDECAY,
            scale_grad=SCALE_GRAD, noise=jnp.asarray(noise), interpret=True)
        want = want._replace(theta=outs[0], momentum=outs[1], tau=outs[2],
                             g=outs[3], v_hat=outs[4], minv=outs[5],
                             step=want.step + 1)
        _, port_grads = fused._grads(got.theta, None)
        got = FusedSGHMCState(*fu.fused_sghmc_update(
            got.theta, got.momentum, got.tau, got.g, got.v_hat, got.minv,
            port_grads, 0.01, got.step < 2, 0, mdecay=MDECAY,
            scale_grad=SCALE_GRAD, noise=torch.tensor(noise)),
            step=got.step + 1)
        for field in FusedSGHMCState._fields[:-1]:
            _close(getattr(got, field)[:, :5].numpy(),
                   np.asarray(getattr(want, field))[:, :5], KERNEL_RTOL,
                   "step {} {}".format(step, field))


def _reference_template():
    """The 1x8 reference network's single-chain dict, in the network's
    order (w1, b1, w2, b2, log_variance_bias), which its sorted order is
    not."""
    init, _ = tl.default_network(1, units=(8,), device="cpu")
    return init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("template", ["two-leaf", "reference"])
def test_init_and_flatten_match_jax_exactly(template):
    if template == "two-leaf":
        port_template = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    else:
        port_template = _reference_template()
        assert list(port_template) != sorted(port_template)
    rng = np.random.RandomState(3)
    stacked = {k: rng.standard_normal((4,) + tuple(v.shape)).astype(
        np.float32) for k, v in port_template.items()}
    jax_fused = JaxFusedSGHMC(
        lambda p: 0.0, {k: jnp.zeros(v.shape)
                        for k, v in port_template.items()}, interpret=True)
    fused = FusedSGHMC(lambda p: 0.0, port_template)
    assert (fused.dim, fused.dim_padded) == (jax_fused.dim,
                                             jax_fused.dim_padded)
    want = jax_fused.init({k: jnp.asarray(v) for k, v in stacked.items()})
    got = fused.init(interop.params_from_numpy(stacked, "cpu"))
    for field in FusedSGHMCState._fields[:-1]:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.step == int(want.step) == 0
    back = fused.unflatten_positions(got.theta)
    want_back = jax_fused.unflatten_positions(want.theta)
    assert set(back) == set(want_back)
    for key, leaf in want_back.items():
        np.testing.assert_array_equal(back[key].numpy(), np.asarray(leaf))
        np.testing.assert_array_equal(back[key].numpy(), stacked[key])


# f32 on both sides, autograd on both: summation order (XLA vs ATen) in the
# forward and backward passes, carried through the steps (the lanes
# drivers' bound, tests/test_torch_lanes.py)
RUN_RTOL = 2e-5


def test_run_matches_jax_interpret_on_zero_bit_stream():
    """``run`` on the degenerate stream against JAX's interpret-mode
    ``run``: 8 chains of the 1x8 reference network, a full-data cost, 12
    steps crossing the burn-in boundary at 6."""
    x, y, _, _ = tl._driver_setup()
    jax_init, jax_apply = tl.jax_default(1, units=(8,))
    positions = jax.vmap(jax_init)(jax.random.split(jax.random.PRNGKey(0),
                                                    8))
    template = {k: leaf[0] for k, leaf in positions.items()}
    kw = dict(stepsize=0.01, burn_in_steps=6, scale_grad=float(x.shape[0]))
    jax_fused = JaxFusedSGHMC(tl._jax_cost(jax_apply, x, y), template,
                              interpret=True, **kw)
    want, want_costs = jax_fused.run(jax_fused.init(positions),
                                     jax.random.PRNGKey(1), 12)
    _, apply = tl.default_network(1, units=(8,), device="cpu")
    bnn = tl.BayesianNeuralNetwork(batch_size=x.shape[0], step_impl="lanes",
                                   device="cpu")
    xt, yt = torch.tensor(x), torch.tensor(y)

    def cost(params):
        return bnn.negative_log_likelihood(apply, params, xt, yt,
                                           x.shape[0])[0]

    port_positions = interop.params_from_numpy(positions, "cpu")
    runs = {}
    for backend in ("pallas", "xla"):
        fused = FusedSGHMC(cost, {k: v[0] for k, v in port_positions.items()},
                           backend=backend, noise_impl="zero", **kw)
        runs[backend] = fused.run(fused.init(port_positions),
                                  torch.Generator().manual_seed(2), 12)
    got, got_costs = runs["pallas"]
    assert got.step == int(want.step) == 12
    for field in FusedSGHMCState._fields[:-1]:
        assert torch.equal(getattr(got, field),
                           getattr(runs["xla"][0], field)), field
    dim = jax_fused.dim
    got_leaves = fused.unflatten_positions(got.theta)
    for key, leaf in jax_fused.unflatten_positions(want.theta).items():
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(
            got_leaves[key].numpy(), leaf, rtol=0,
            atol=RUN_RTOL * np.abs(leaf).max(), err_msg=key)
    for field in ("momentum", "minv", "v_hat"):
        _close(getattr(got, field)[:, :dim].numpy(),
               np.asarray(getattr(want, field))[:, :dim], RUN_RTOL, field)
    _close(got_costs.numpy(), np.asarray(want_costs), RUN_RTOL, "costs")


def test_run_takes_batches_and_shared_windows():
    """``run`` with a ``batch_fn``: per chain, each chain's own window of
    the Philox stream; ``per_chain_batches=False``, chain 0's window for
    every chain."""
    x = torch.linspace(-1.0, 1.0, 30)[:, None]
    y = 2.0 * x[:, 0]
    select = batch_fn(x, y, batch_size=5)
    seen = []

    def recording(seed, step, n_chains):
        batch = select(seed, step, n_chains)
        seen.append(batch)
        return batch

    def cost(params, batch):
        xb, yb = batch
        return torch.sum((yb[:, 0] - xb[:, 0] * params["w"][0]) ** 2)

    fused = FusedSGHMC(cost, {"w": torch.zeros(1)}, stepsize=1e-3,
                       burn_in_steps=5)
    for shared in (False, True):
        seen.clear()
        state, costs = fused.run(fused.init({"w": torch.zeros(4, 1)}),
                                 torch.Generator().manual_seed(0), 10,
                                 batch_fn=recording,
                                 per_chain_batches=not shared)
        assert state.step == 10 and costs.shape == (4,)
        assert torch.isfinite(costs).all()
        assert [b[0].shape[0] for b in seen] == [1 if shared else 4] * 10
    per_chain = fused.run(fused.init({"w": torch.zeros(4, 1)}),
                          torch.Generator().manual_seed(0), 3,
                          batch_fn=select)[0]
    assert not torch.equal(per_chain.theta[0], per_chain.theta[1])


def test_compute_dtype_runs_the_network_in_bf16_with_f32_gradients():
    fused = FusedSGHMC(_port_quadratic, {"a": torch.zeros(3),
                                         "b": torch.zeros(2)},
                       compute_dtype=torch.bfloat16)
    theta = fused.flatten_positions({"a": torch.full((2, 3), 1.5),
                                     "b": torch.full((2, 2), -0.5)})
    costs, grads = fused._grads(theta, None)
    assert grads.dtype == torch.float32 and grads.shape == theta.shape
    assert torch.equal(grads[:, 5:], torch.zeros_like(grads[:, 5:]))
    assert torch.allclose(grads[:, :5], torch.tensor([[1.5] * 3 + [-1.0] *
                                                      2] * 2))


def test_fused_sghmc_refuses_what_it_cannot_take():
    template = {"x": torch.zeros(2)}
    with pytest.raises(ValueError, match="backend"):
        FusedSGHMC(_port_quadratic, template, backend="triton")
    with pytest.raises(ValueError, match="hadamard_clt"):
        FusedSGHMC(_port_quadratic, template, noise_impl="hadamard_clt")
    fused = FusedSGHMC(lambda p: torch.sum(p["x"] ** 2), template,
                       backend="xla")
    with pytest.raises(ValueError, match="needs a key"):
        fused.step(fused.init({"x": torch.zeros(2, 2)}))


def test_state_crosses_with_interop():
    jax_fused = JaxFusedSGHMC(lambda p: jnp.sum(p["x"] ** 2),
                              {"x": jnp.zeros(3)}, interpret=True)
    want = jax_fused.init({"x": jnp.arange(6.0).reshape(2, 3)})
    want = want._replace(step=jnp.asarray(7, jnp.int32))
    got = interop.fused_sghmc_state_from_numpy(want, "cpu")
    assert isinstance(got, FusedSGHMCState) and got.step == 7
    back = interop.state_to_numpy(got)
    assert set(back) == set(FusedSGHMCState._fields)
    for field in FusedSGHMCState._fields:
        np.testing.assert_array_equal(back[field],
                                      np.asarray(getattr(want, field)))


@pytest.mark.parametrize("module", [fu, fused_module, packed_module],
                         ids=lambda m: m.__name__)
def test_new_module_doctests(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0 and results.attempted > 0, module.__name__


def test_new_modules_import_no_jax():
    code = ("import sys, pysgmcmc_tpu_torch.ops.fused_update, "
            "pysgmcmc_tpu_torch.samplers.fused, "
            "pysgmcmc_tpu_torch.parallel.packed; "
            "sys.exit(int('jax' in sys.modules))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stderr or "jax was imported"
