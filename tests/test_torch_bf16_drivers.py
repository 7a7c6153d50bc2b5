"""The port's chain drivers at the JAX package's default dtypes, against
JAX's drivers in interpret mode on the zero-bit stream: the lanes drivers
without ``compute_dtype`` (bf16 network passes in both packages) with f32
and bf16 state, and the fused driver without ``state_dtype`` (bf16
momentum).  Inputs are made with numpy seeds and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.models.architectures import dense_network as jax_dense
from pysgmcmc_tpu.parallel import packed as jpacked
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler as JaxSGHMC
from pysgmcmc_tpu.samplers.sgld import SGLDSampler as JaxSGLD
from pysgmcmc_tpu_torch import interop
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_lanes,
    sample_chain_fused,
    sample_chain_lanes,
)
from pysgmcmc_tpu_torch.samplers import SGHMCSampler, SGLDSampler
from tests import test_torch_fused_samplers as tfs
from tests import test_torch_lanes as tl
from tests import test_torch_samplers_lanes as tsl
from tests.test_torch_fused_step import BATCH, N_DATA

# bf16 network passes on both sides: the same bf16 leaves and inputs, f32
# products (jnp.dot and the port's apply promote), then the gradient rounded
# to bf16; summation order still differs (XLA vs ATen), and where an f32
# gradient straddles a bf16 rounding boundary the two round it one ulp
# (2**-8 of it) apart, carried over 16 steps.  Of each leaf's largest
# |value|; measured: positions up to 9.9e-4 (pSGLD, bf16 state; the others
# 2.9e-4 and below), momenta and accumulators up to 1.3e-2 (pSGLD's
# accumulator, whose g^2 doubles a gradient's ulp; the others 6.4e-3 and
# below).  The bounds are about twice that.
LANES_BF16_RTOL = dict(positions=2e-3, state=3e-2)
LANES_SAMPLERS = {
    "SGHMC": (JaxSGHMC, SGHMCSampler, dict(burn_in_steps=8)),
    "SGLD": (JaxSGLD, SGLDSampler, dict(burn_in_steps=8)),
    "PSGLD": tsl.SAMPLERS["PSGLD"][:2] + (tsl.SAMPLERS["PSGLD"][3],),
    "SGNHT": tsl.SAMPLERS["SGNHT"][:2] + (tsl.SAMPLERS["SGNHT"][3],),
    "RelativisticSGHMC": (tsl.SAMPLERS["RelativisticSGHMC"][:2]
                          + (tsl.SAMPLERS["RelativisticSGHMC"][3],)),
}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", sorted(LANES_SAMPLERS))
def test_lanes_drivers_match_jax_at_default_compute_dtype(method,
                                                          state_dtype):
    """The lanes drivers without ``compute_dtype`` (bf16 network passes in
    both packages), f32 or bf16 state, against JAX's interpret-mode
    drivers on the zero-bit stream: SGHMC and SGLD 8 burn-in steps then 2
    samples of 4, the others 2 samples of 8 (SGNHT's thermostat summing the
    stored momentum)."""
    jax_cls, port_cls, kw = LANES_SAMPLERS[method]
    x, y, apply, positions = tl._driver_setup()
    kw = dict(kw, stepsize_schedule=1e-3)
    if method in ("SGHMC", "SGLD"):
        kw["scale_grad"] = float(tl.DRIVER_DATA)
    jax_sampler = jax_cls(tl._jax_cost(apply, x, y), **kw)
    states = jax.vmap(jax_sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(1), tl.N_CHAINS))
    jdtype = getattr(jnp, state_dtype)
    drive = dict(batch_fn=None, backend="pallas", interpret=True)
    sampler = port_cls(tl._port_cost(x, y), **kw)
    dtype = getattr(torch, state_dtype)
    gen = torch.Generator().manual_seed(0)
    if method in ("SGHMC", "SGLD"):  # both burn in at their defaults first
        states = jpacked.burnin_chain_lanes(jax_sampler, states,
                                            jax.random.PRNGKey(2), 8,
                                            **drive)
        start = burnin_chain_lanes(
            sampler, sampler.init(interop.params_from_numpy(positions,
                                                            "cpu")),
            gen, 8, noise_impl="zero")
        keep = 4
    else:
        start = tsl.SAMPLERS[method][2](states, "cpu")._replace(
            step=torch.zeros((), dtype=torch.int64))
        keep = 8
    start = start._replace(schedule_state=sampler.stepsize_schedule.init())
    want_states, want_pos, _ = jpacked.sample_chain_lanes(
        jax_sampler, states, jax.random.PRNGKey(3), 2, keep_every=keep,
        state_dtype=jdtype, **drive)
    got_states, got_pos, _ = sample_chain_lanes(
        sampler, start, gen, 2, keep_every=keep, state_dtype=dtype,
        noise_impl="zero")
    tsl._leaves_close(got_pos, want_pos, LANES_BF16_RTOL["positions"],
                      "positions")
    for field in ("momentum", "v"):
        if hasattr(want_states, field):
            got_field = getattr(got_states, field)
            assert all(leaf.dtype == torch.float32
                       for leaf in got_field.values())
            tsl._leaves_close(got_field, getattr(want_states, field),
                              LANES_BF16_RTOL["state"], field)
    if method == "SGNHT":
        np.testing.assert_allclose(got_states.xi.numpy(),
                                   np.asarray(want_states.xi), rtol=1e-4)


# the fused driver at JAX's default bf16 state, of each leaf's largest
# |value| over 6 steps at width 8: the TPU kernels' bf16 matrix operands
# (tests/test_torch_fused_samplers.py) and the state's rounding.  Measured
# on positions / momentum or accumulator: pSGLD 1.3e-2 / 5.4e-3 (its f32
# accumulator: as at f32), SGNHT 2.6e-3 / 5.2e-3, relativistic SGHMC 2.6e-3
# / 3.3e-3; the bounds are about twice that.
FUSED_DRIVER_RTOL = {"psgld": 3e-2, "sgnht": 1e-2, "rsghmc": 1e-2}


@pytest.mark.parametrize("kind", sorted(FUSED_DRIVER_RTOL))
def test_fused_driver_matches_jax_at_default_state_dtype(kind):
    """``sample_chain_fused(multistep=True)`` with neither side given a
    ``state_dtype`` (bf16 momentum; pSGLD's accumulator f32 in both)
    against JAX's driver in interpret mode; the momentum comes back
    float32 on both sides."""
    jax_cls, port_cls, from_numpy = tfs.SAMPLERS[kind]
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (N_DATA, 1)).astype(np.float32)
    y = np.sinc(10.0 * x[:, 0] - 5.0).astype(np.float32)
    init, _ = jax_dense(1, units=(tfs.DRIVER_H, tfs.DRIVER_H))
    positions = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0),
                                                tfs.DRIVER_CHAINS))
    kw = tfs._sampler_kw(kind)
    jax_sampler = jax_cls(lambda p, b: 0.0, **kw)
    states = jax.vmap(jax_sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(1),
                                    tfs.DRIVER_CHAINS))
    want_states, want_pos, _ = jpacked.sample_chain_fused(
        jax_sampler, states, jax.random.PRNGKey(2), 2, x, y,
        batch_size=BATCH, keep_every=3, multistep=True,
        noise_impl="box_muller", interpret=True)
    sampler = port_cls(lambda p, b: None, **kw)
    start = from_numpy(states, "cpu")._replace(
        schedule_state=sampler.stepsize_schedule.init())
    got_states, got_pos, _ = sample_chain_fused(
        sampler, start, torch.Generator().manual_seed(0), 2, x, y,
        batch_size=BATCH, keep_every=3, multistep=True, noise_impl="zero")
    tfs._leaves_close(got_pos, want_pos, FUSED_DRIVER_RTOL[kind],
                      "positions")
    field = "v" if kind == "psgld" else "momentum"
    got_field = getattr(got_states, field)
    assert all(leaf.dtype == torch.float32 for leaf in got_field.values())
    tfs._leaves_close(got_field, getattr(want_states, field),
                      FUSED_DRIVER_RTOL[kind], field)


