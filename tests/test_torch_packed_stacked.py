"""The packed and stacked SGHMC drivers and their kernels B7 mask and B7' in
the port against the JAX package.

- The slot layout (``make_pack_spec``, ``pack_tree``, ``unpack_tree``,
  ``pack_mask``) is the functions' public contract: held exactly, on a
  two-leaf template, ``tests/parallel/test_packed.py``'s template and the
  3x50 reference network (6,016 columns, nine 128-aligned slots, for
  5,252 parameters).
- B7 mask: ``slim_sghmc_update_ref`` with a mask against JAX's Pallas
  kernel in interpret mode, with injected noise that is non-zero on the
  padding columns (on the zero-bit stream the momentum stays 0 there and
  the mask is never exercised), f32 and bf16 gradient, rtol 1e-6.
- B7': ``slim_sghmc_update_tree_ref`` against JAX's
  ``slim_sghmc_update_tree`` in interpret mode, with and without the bf16
  copy, rtol 1e-6 (the copy exactly).
- The drivers against JAX's ``sample_chain_packed`` and
  ``sample_chain_stacked`` (``backend="pallas", interpret=True``) on the
  zero-bit stream, each at its default dtype, and against each other and
  ``sample_chain_lanes``; their bookkeeping and refusals
  (``tests/parallel/test_packed.py:183-203``, ``:362-368``); and the
  Gaussian-moment test of ``:148-180`` / ``:264-297`` on the port's
  ``backend="pallas"`` plain path, burned in with ``burnin_chain_lanes``.

Inputs are made with numpy seeds.  The CUDA kernels are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.ops import slim_update as jsu
from pysgmcmc_tpu.parallel import packed as jpacked
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler as JaxSGHMC
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.ops import slim_update as su
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_lanes,
    make_pack_spec,
    pack_mask,
    pack_tree,
    sample_chain_lanes,
    sample_chain_packed,
    sample_chain_stacked,
    unpack_tree,
)
from pysgmcmc_tpu_torch.samplers import SGHMCSampler, SGLDSampler
from pysgmcmc_tpu_torch.stepsize_schedules import TracedStepsizeSchedule
from tests import test_torch_lanes as tl
from tests import test_torch_samplers_lanes as tsl

KERNEL_RTOL = 1e-6
CONSTANTS = dict(mdecay=0.05, scale_grad=10.0, prior_scale=0.125)


def _templates():
    """Single-chain shapes: two leaves, JAX's packed-test template, and the
    3x50 reference network (in its own dict order)."""
    init, _ = tl.default_network(1, units=(50, 50, 50), device="cpu")
    reference = {k: tuple(v.shape) for k, v in
                 init(torch.Generator().manual_seed(0)).items()}
    return {
        "two-leaf": {"w": (2, 3), "b": (2,)},
        "jax-test": {"W1": (1, 50), "b1": (50,), "W2": (50, 50),
                     "b2": (50,), "W4": (50, 2), "b4": (2,)},
        "reference": reference,
    }


@pytest.mark.parametrize("name", sorted(_templates()))
def test_pack_layout_matches_jax_exactly(name):
    shapes = _templates()[name]
    rng = np.random.RandomState(0)
    stacked = {k: rng.standard_normal((4,) + s).astype(np.float32)
               for k, s in shapes.items()}
    want_spec = jpacked.make_pack_spec({k: jnp.zeros(s)
                                        for k, s in shapes.items()})
    spec = make_pack_spec({k: torch.zeros(s) for k, s in shapes.items()})
    assert spec.names == tuple(sorted(shapes))
    assert (spec.shapes, spec.sizes, spec.offsets, spec.width) == (
        want_spec.shapes, want_spec.sizes, want_spec.offsets,
        want_spec.width)
    if name == "reference":
        assert (spec.width, sum(spec.sizes)) == (6016, 5252)
    flat = pack_tree(spec, interop.params_from_numpy(stacked, "cpu"))
    want = jpacked.pack_tree(want_spec, {k: jnp.asarray(v)
                                         for k, v in stacked.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pack_mask(spec, device="cpu").numpy(),
                                  np.asarray(jpacked.pack_mask(want_spec)))
    back = unpack_tree(spec, flat)
    for key, leaf in stacked.items():
        np.testing.assert_array_equal(back[key].numpy(), leaf)
    assert unpack_tree(spec, flat, torch.bfloat16)[spec.names[0]].dtype \
        == torch.bfloat16


def test_pack_mask_defaults_to_the_card():
    """``pack_mask`` allocates on the card unless the CPU is asked for, as
    JAX's lands on the default accelerator; without a card it raises
    instead of handing back a CPU mask."""
    assert inspect.signature(pack_mask).parameters["device"].default \
        == "cuda"
    spec = make_pack_spec({"w": torch.zeros(2, 3)})
    if torch.cuda.is_available():
        assert pack_mask(spec).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pack_mask(spec)
    assert pack_mask(spec, device="cpu").device.type == "cpu"


def _masked_inputs(seed=0, n=8):
    """Packed operands of the two-leaf template's slots, the padding
    columns of theta and v at 0 (as the packed driver keeps them), and
    noise that is non-zero everywhere."""
    spec = make_pack_spec({"w": torch.zeros(2, 3), "b": torch.zeros(2)})
    rng = np.random.RandomState(seed)
    mask = np.asarray(pack_mask(spec, device="cpu"))

    def arr(lo=None, hi=None):
        if lo is None:
            return rng.standard_normal((n, spec.width)).astype(np.float32)
        return rng.uniform(lo, hi, (n, spec.width)).astype(np.float32)

    out = {"theta": arr() * mask, "v": 1e-2 * arr() * mask, "grad": arr(),
           "minv": arr(0.1, 2.0), "noise": arr(), "mask": mask}
    return spec, out


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_masked_plain_version_matches_pallas_kernel(grad_dtype):
    spec, inputs = _masked_inputs()
    names = ("theta", "v", "grad", "minv")
    jax_args = [jnp.asarray(inputs[k]) for k in names]
    port_args = [torch.tensor(inputs[k]) for k in names]
    if grad_dtype == "bfloat16":
        jax_args[2] = jax_args[2].astype(jnp.bfloat16)
        port_args[2] = interop.tensor_from_numpy(jax_args[2], "cpu")
    want = jsu.slim_sghmc_update(
        *jax_args, jnp.asarray(inputs["mask"]), 0.05, 0,
        noise=jnp.asarray(inputs["noise"]), interpret=True, **CONSTANTS)
    got = su.slim_sghmc_update(
        *port_args, torch.tensor(inputs["mask"]), 0.05, 3,
        noise=torch.tensor(inputs["noise"]), **CONSTANTS)
    pad = inputs["mask"][0] == 0
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=KERNEL_RTOL,
                                   atol=KERNEL_RTOL * np.abs(b).max(),
                                   err_msg="output {}".format(i))
        # the padding: v' exactly 0, theta' unmoved (0)
        assert not a[:, pad].any(), i
    # without the mask the noise moves the padding
    loose = su.slim_sghmc_update(*port_args, None, 0.05, 3,
                                 noise=torch.tensor(inputs["noise"]),
                                 **CONSTANTS)
    assert loose[1][:, pad].abs().min() > 0


def test_noise_index_keys_each_column_to_its_element():
    spec, inputs = _masked_inputs(1)
    args = [torch.tensor(inputs[k]) for k in ("theta", "v", "grad", "minv")]
    mask = torch.tensor(inputs["mask"])
    index = torch.arange(spec.width, dtype=torch.int32).flip(0)
    got = su.slim_sghmc_update(*args, mask, 0.05, 9, step=4,
                               noise_index=index, **CONSTANTS)[1]
    eta = su.philox_normals(9, 4, 8, spec.width, "cpu", index)
    want = su.slim_sghmc_update(*args, mask, 0.05, 9, noise=eta,
                                **CONSTANTS)[1]
    assert torch.equal(got, want)
    for bad in (index.long(), index[:5]):
        with pytest.raises(ValueError, match="noise_index"):
            su.slim_sghmc_update(*args, mask, 0.05, 9, noise_index=bad)
    with pytest.raises(ValueError, match="noise_index"):
        su.slim_sghmc_update(*args, None, 0.05, 9, noise_index=index)
    with pytest.raises(ValueError, match="mask must be"):
        su.slim_sghmc_update(*args, mask[:, :5], 0.05, 9)


def _tree_inputs(seed=0, n=4):
    rng = np.random.RandomState(seed)
    shapes = {"W1": (1, 12), "b1": (12,), "W2": (12, 12)}

    def tree(lo=None, hi=None):
        return {k: (rng.standard_normal((n,) + s) if lo is None else
                    rng.uniform(lo, hi, (n,) + s)).astype(np.float32)
                for k, s in shapes.items()}

    return {"theta": tree(), "v": {k: 1e-2 * x for k, x in tree().items()},
            "grad": tree(), "minv": tree(0.1, 2.0), "noise": tree()}


@pytest.mark.parametrize("emit_bf16", [False, True])
def test_tree_plain_version_matches_pallas_kernel(emit_bf16):
    inputs = _tree_inputs()
    names = ("theta", "v", "grad", "minv")
    want = jsu.slim_sghmc_update_tree(
        *[{k: jnp.asarray(x) for k, x in inputs[n].items()} for n in names],
        0.05, 0, noise={k: jnp.asarray(x) for k, x in
                        inputs["noise"].items()},
        emit_bf16=emit_bf16, interpret=True, **CONSTANTS)
    got = su.slim_sghmc_update_tree(
        *[interop.params_from_numpy(inputs[n], "cpu") for n in names],
        0.05, 3, noise=interop.params_from_numpy(inputs["noise"], "cpu"),
        emit_bf16=emit_bf16, **CONSTANTS)
    assert len(got) == len(want) == (3 if emit_bf16 else 2)
    for i, (a, b) in enumerate(zip(got[:2], want[:2])):
        assert list(a) == list(inputs["theta"])  # the dict's order
        for key, leaf in b.items():
            leaf = np.asarray(leaf)
            np.testing.assert_allclose(
                a[key].numpy(), leaf, rtol=KERNEL_RTOL,
                atol=KERNEL_RTOL * np.abs(leaf).max(),
                err_msg="output {} {}".format(i, key))
    if emit_bf16:
        for key, leaf in got[2].items():
            assert leaf.dtype == torch.bfloat16
            assert torch.equal(leaf, got[0][key].to(torch.bfloat16))
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(want[2][key], np.float32),
                                       rtol=2 ** -7)


def test_tree_draws_the_lanes_normals():
    """On the Philox stream, B7' over a stacked dict equals B7 over the
    dict's lanes packing (each element's normal keyed by its index in the
    chain's unpadded row, the leaves in the dict's order), with a bf16
    gradient too."""
    inputs = {n: interop.params_from_numpy(t, "cpu")
              for n, t in _tree_inputs(1).items()}
    spec = tl.make_lanes_spec({k: v[0] for k, v in inputs["theta"].items()})
    for grad_dtype in (torch.float32, torch.bfloat16):
        grad = {k: g.to(grad_dtype) for k, g in inputs["grad"].items()}
        theta, v = su.slim_sghmc_update_tree(
            inputs["theta"], inputs["v"], grad, inputs["minv"], 0.05, 11,
            step=5, **CONSTANTS)
        want = su.slim_sghmc_update(
            *[tl.pack_lanes(spec, t, dtype=t[spec.names[0]].dtype)
              for t in (inputs["theta"], inputs["v"], grad,
                        inputs["minv"])],
            None, 0.05, 11, step=5, **CONSTANTS)
        assert torch.equal(tl.pack_lanes(spec, theta), want[0])
        assert torch.equal(tl.pack_lanes(spec, v), want[1])


def test_tree_wrapper_refuses_what_it_cannot_take():
    inputs = {n: interop.params_from_numpy(t, "cpu")
              for n, t in _tree_inputs().items()}
    args = [inputs[n] for n in ("theta", "v", "grad", "minv")]
    bad_v = dict(args[1], b1=args[1]["b1"].bfloat16())
    with pytest.raises(ValueError, match="match theta"):
        su.slim_sghmc_update_tree(args[0], bad_v, *args[2:], 0.05, 0)
    mixed = dict(args[2], b1=args[2]["b1"].bfloat16())
    with pytest.raises(ValueError, match="one type"):
        su.slim_sghmc_update_tree(*args[:2], mixed, args[3], 0.05, 0)
    with pytest.raises(ValueError, match="theta's keys"):
        su.slim_sghmc_update_tree(args[0], {"b1": args[1]["b1"]},
                                  *args[2:], 0.05, 0)
    with pytest.raises(ValueError, match="scalar"):
        su.slim_sghmc_update_tree(*args, torch.ones(4), 0)
    launches = su.slim_sghmc_update_tree.launches
    su.slim_sghmc_update_tree(*args, 0.05, 0)
    assert su.slim_sghmc_update_tree.launches == launches  # plain version


#  The drivers ------------------------------------------------------------------

# f32 passes: summation order (XLA vs ATen) carried through the steps (the
# lanes drivers' bound; measured 1.1e-7 of a leaf's largest |value| on
# positions, 3.3e-7 on momenta).  bf16 passes (sample_chain_packed's
# default, sample_chain_stacked's bf16_params): where an f32 gradient
# straddles a bf16 rounding boundary the two round it an ulp apart, carried
# over 8 steps; measured 6.7e-6 on positions and 4.1e-4 on momenta, both
# drivers.  The bounds are about four times that.
DRIVER_RTOL = 2e-5
BF16_RTOL = dict(positions=3e-5, state=2e-3)
N_DRIVER = 16


@pytest.fixture(scope="module")
def driver_start():
    """A JAX SGHMC state of N_DRIVER chains of the 2x8 reference network,
    8 steps into burn-in (JAX's pytree sampler, its own noise), handed to
    the port; both samplers with a full-data cost."""
    x, y, apply, positions = tl._driver_setup()
    positions = {k: v[:N_DRIVER] for k, v in positions.items()}
    kw = dict(stepsize_schedule=1e-3, scale_grad=float(tl.DRIVER_DATA),
              burn_in_steps=8, gaussian_prior_scale=0.01)
    jax_sampler = JaxSGHMC(tl._jax_cost(apply, x, y), **kw)
    states = jax.vmap(jax_sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(1), N_DRIVER))

    def burn(state, key):
        for k in jax.random.split(key, 8):
            state, _ = jax_sampler.step(state, k)
        return state

    states = jax.jit(jax.vmap(burn))(
        states, jax.random.split(jax.random.PRNGKey(2), N_DRIVER))
    sampler = SGHMCSampler(tl._port_cost(x, y), **kw)
    start = interop.sghmc_state_from_numpy(
        states, "cpu", schedule_state=sampler.stepsize_schedule.init())
    return jax_sampler, states, sampler, start


@pytest.mark.parametrize("driver", ["packed", "stacked"])
def test_drivers_match_jax_interpret_at_their_defaults(driver,
                                                      driver_start):
    """Each driver at its default dtype (packed: bf16 network passes;
    stacked: f32) against JAX's on the zero-bit stream, 2 samples of 4
    steps; packed also at ``compute_dtype=None`` and stacked at
    ``bf16_params=True``."""
    jax_sampler, states, sampler, start = driver_start
    jax_fn, port_fn, other = {
        "packed": (jpacked.sample_chain_packed, sample_chain_packed,
                   dict(compute_dtype=None)),
        "stacked": (jpacked.sample_chain_stacked, sample_chain_stacked,
                    dict(bf16_params=True)),
    }[driver]
    for kw in ({}, other):
        bf16 = (driver == "packed") != bool(kw)
        tol = BF16_RTOL if bf16 else dict(positions=DRIVER_RTOL,
                                          state=DRIVER_RTOL)
        want_states, want_pos, want_costs = jax_fn(
            jax_sampler, states, jax.random.PRNGKey(3), 2, keep_every=4,
            backend="pallas", interpret=True, **kw)
        got_states, got_pos, got_costs = port_fn(
            sampler, start, torch.Generator().manual_seed(0), 2,
            keep_every=4, noise_impl="zero", **kw)
        np.testing.assert_array_equal(got_states.step.numpy(),
                                      np.asarray(want_states.step))
        assert int(got_states.step[0]) == 16
        assert list(got_states.position) == list(start.position)
        tsl._leaves_close(got_pos, want_pos, tol["positions"], "positions")
        tsl._leaves_close(got_states.momentum, want_states.momentum,
                          tol["state"], "momentum")
        assert all(leaf.dtype == torch.float32
                   for leaf in got_states.momentum.values())
        np.testing.assert_allclose(got_costs.numpy(), np.asarray(want_costs),
                                   rtol=tol["positions"])


def test_packed_stacked_and_lanes_drivers_agree(driver_start):
    """From one state and one generator seed, on the Philox stream with a
    minibatch per chain, the three drivers give the same chains (f32
    passes): windows, noise and arithmetic are the same per element."""
    start = driver_start[3]
    x, y, _, _ = tl._driver_setup()
    bnn = tl.BayesianNeuralNetwork(batch_size=20, step_impl="lanes",
                                   device="cpu")
    _, apply = tl.default_network(1, units=(8, 8), device="cpu")

    def cost(params, batch):
        return bnn.negative_log_likelihood(apply, params, *batch,
                                           tl.DRIVER_DATA)[0]

    sampler = SGHMCSampler(cost, stepsize_schedule=1e-3,
                           scale_grad=float(tl.DRIVER_DATA),
                           gaussian_prior_scale=0.01)
    select = batch_fn(x, y, 20)
    runs = {}
    for name, fn, kw in (
            ("lanes", sample_chain_lanes, dict(compute_dtype=None)),
            ("packed", sample_chain_packed, dict(compute_dtype=None)),
            ("stacked", sample_chain_stacked, {})):
        runs[name] = fn(sampler, start, torch.Generator().manual_seed(5), 2,
                        batch_fn=select, keep_every=3, **kw)
    for name in ("packed", "stacked"):
        for i in (0, 2):
            got, want = runs[name][i], runs["lanes"][i]
            if i == 0:
                for field in ("position", "momentum"):
                    for key in start.position:
                        assert torch.equal(getattr(got, field)[key],
                                           getattr(want, field)[key]), (
                            name, field, key)
            else:
                assert torch.equal(got, want), name
        for key in start.position:
            assert torch.equal(runs[name][1][key], runs["lanes"][1][key])


def _gaussian_sampler(**kwargs):
    # standard normal target: cost = 0.5 ||x||^2 (ignores the batch)
    defaults = dict(stepsize_schedule=0.1, burn_in_steps=100, mdecay=0.05)
    defaults.update(kwargs)
    return SGHMCSampler(
        lambda p: 0.5 * sum(torch.sum(x ** 2) for x in p.values()),
        **defaults)


def test_packed_updates_state_bookkeeping():
    """``tests/parallel/test_packed.py:183-203`` for both drivers."""
    sampler = _gaussian_sampler(burn_in_steps=0)
    states = sampler.init({"x": torch.ones(4, 3)})
    for fn in (sample_chain_packed, sample_chain_stacked):
        new_states, pos, costs = fn(
            sampler, states, torch.Generator().manual_seed(1), 3,
            keep_every=2, **({"compute_dtype": None}
                             if fn is sample_chain_packed else {}),
            backend="xla")
        assert int(new_states.step) == 6
        assert costs.shape == (4, 3)
        assert pos["x"].shape == (4, 3, 3)
        assert torch.equal(pos["x"][:, -1], new_states.position["x"])
        assert new_states.stats is states.stats
        _, none, _ = fn(sampler, states, torch.Generator().manual_seed(1),
                        1, collect_positions=False)
        assert none is None


def test_drivers_refuse_what_they_cannot_take():
    """``tests/parallel/test_packed.py:362-368``: SGHMC only; and the
    port's checks."""
    sgld = SGLDSampler(lambda p: torch.sum(p["x"] ** 2),
                       stepsize_schedule=0.01)
    for fn in (sample_chain_packed, sample_chain_stacked):
        with pytest.raises(NotImplementedError, match="SGHMCSampler"):
            fn(sgld, None, torch.Generator(), 1)
    sampler = _gaussian_sampler()
    states = sampler.init({"x": torch.ones(4, 3)})
    gen = torch.Generator()
    with pytest.raises(ValueError, match="backend"):
        sample_chain_packed(sampler, states, gen, 1, backend="triton")
    with pytest.raises(ValueError, match="compute_dtype"):
        sample_chain_packed(sampler, states, gen, 1,
                            compute_dtype=torch.float16)
    # JAX's stacked driver has Box-Muller only
    with pytest.raises(ValueError, match="hadamard_clt"):
        sample_chain_stacked(sampler, states, gen, 1,
                             noise_impl="hadamard_clt")
    traced = SGHMCSampler(sampler.cost_fn,
                          stepsize_schedule=TracedStepsizeSchedule(0.1))
    sweep = traced.init({"x": torch.ones(4, 3)})._replace(
        schedule_state=torch.tensor([0.1, 0.1, 0.2, 0.1]))
    for fn in (sample_chain_packed, sample_chain_stacked):
        with pytest.raises(ValueError, match="heterogeneous"):
            fn(traced, sweep, gen, 1)
    shared = sweep._replace(schedule_state=torch.full((4,), 0.1))
    assert int(sample_chain_stacked(traced, shared, gen, 1)[0].step) == 1


@pytest.mark.parametrize("driver", ["packed", "stacked", "stacked-bf16"])
def test_drivers_sample_gaussian_moments(driver):
    """The Gaussian-moment test of ``tests/parallel/test_packed.py:148-180``
    and ``:264-297`` on the port's ``backend="pallas"`` path (the plain
    versions on the CPU, Philox noise), burned in with
    ``burnin_chain_lanes``.  JAX's 64,000 draws come from twice its chains
    (32) and half its samples (200 of 5 steps each), which halves the
    host's per-step work on the CPU."""
    sampler = _gaussian_sampler()
    n = 32
    rng = np.random.RandomState(3)
    positions = {"x": torch.tensor(0.1 * rng.standard_normal((n, 4)),
                                   dtype=torch.float32),
                 "y": torch.tensor(0.1 * rng.standard_normal((n, 2, 3)),
                                   dtype=torch.float32)}
    states = burnin_chain_lanes(sampler, sampler.init(positions),
                                torch.Generator().manual_seed(5), 100,
                                compute_dtype=None)
    if driver == "packed":
        run = sample_chain_packed(sampler, states,
                                  torch.Generator().manual_seed(6), 200,
                                  keep_every=5, compute_dtype=None)
    else:
        run = sample_chain_stacked(sampler, states,
                                   torch.Generator().manual_seed(6), 200,
                                   keep_every=5,
                                   bf16_params=driver == "stacked-bf16")
    states, positions, costs = run
    draws = torch.cat([leaf.reshape(-1) for leaf in positions.values()])
    assert torch.isfinite(draws).all()
    assert abs(float(draws.mean())) < 0.1
    assert abs(float(draws.std()) - 1.0) < 0.15
    assert costs.shape == (n, 200)
    assert int(states.step) == 100 + 200 * 5
