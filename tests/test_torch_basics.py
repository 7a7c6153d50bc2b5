"""Leaf modules of the PyTorch port against the JAX package, the Philox
stream against its known answers and N(0, 1), and the port's import
boundary (no JAX)."""

import doctest
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pysgmcmc_tpu import sampling as jax_sampling
from pysgmcmc_tpu import stepsize_schedules as jax_schedules
from pysgmcmc_tpu.diagnostics import objective_functions as jax_objectives
from pysgmcmc_tpu.models import base_model as jax_base_model
from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.utils import numeric as jax_numeric
import pysgmcmc_tpu_torch.data_batches
import pysgmcmc_tpu_torch.interop
import pysgmcmc_tpu_torch.models.architectures
import pysgmcmc_tpu_torch.models.bayesian_neural_network
import pysgmcmc_tpu_torch.ops.pairwise
import pysgmcmc_tpu_torch.ops.svgd_streaming
import pysgmcmc_tpu_torch.samplers._adaptive
import pysgmcmc_tpu_torch.samplers.sghmc
import pysgmcmc_tpu_torch.samplers.sgld
import pysgmcmc_tpu_torch.samplers.svgd
import pysgmcmc_tpu_torch.utils.pytree
from pysgmcmc_tpu_torch import sampling, stepsize_schedules
from pysgmcmc_tpu_torch.diagnostics import objective_functions
from pysgmcmc_tpu_torch.models import base_model
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.utils import numeric, pytree, tracing


def _edge_inputs():
    rng = np.random.RandomState(0)
    vals = rng.standard_normal(64).astype(np.float32) * 3.0
    vals[:6] = [0.0, -0.0, 1e-16, -1e-16, -1e-30, 1e30]
    return vals


def test_safe_divide_matches_jax_exactly():
    x = np.linspace(-2.0, 2.0, 64).astype(np.float32)
    y = _edge_inputs()
    want = np.asarray(jax_numeric.safe_divide(jnp.asarray(x), jnp.asarray(y)))
    got = numeric.safe_divide(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_array_equal(got, want)


def test_safe_sqrt_matches_jax_exactly():
    x = _edge_inputs()
    want = np.asarray(jax_numeric.safe_sqrt(jnp.asarray(x)))
    np.testing.assert_array_equal(numeric.safe_sqrt(torch.tensor(x)).numpy(),
                                  want)


def test_constant_schedule_matches_jax():
    want = jax_schedules.ConstantStepsizeSchedule(0.01)
    got = stepsize_schedules.ConstantStepsizeSchedule(0.01)
    assert [next(got) for _ in range(4)] == [next(want) for _ in range(4)]
    assert got.value(got.init(), 123) == want.value(want.init(), 123)
    assert got.init() == want.init()
    assert str(got) == str(want)


def test_traced_schedule_matches_jax():
    want = jax_schedules.TracedStepsizeSchedule(0.05)
    got = stepsize_schedules.TracedStepsizeSchedule(0.05)
    assert [next(got) for _ in range(3)] == [next(want) for _ in range(3)]
    assert float(got.value(got.init(), 9)) == float(want.value(want.init(), 9))
    assert float(got.value(torch.tensor(0.25), 0)) == 0.25
    assert str(got) == str(want)


@pytest.mark.parametrize("n_inputs,batch", [(1, 20), (3, 7), (1, 24)])
def test_windows_match_jax_exactly(n_inputs, batch):
    rng = np.random.RandomState(1)
    x = rng.uniform(size=(100, n_inputs)).astype(np.float32)
    y = rng.standard_normal(100).astype(np.float32)
    jx, jy = jfs.data_windows(x, y, batch)
    tx, ty = fs.data_windows(torch.tensor(x), torch.tensor(y), batch)
    assert tx.shape[0] == 100 - batch + 1 == jx.shape[0]
    # the JAX tables carry zero rows past the batch (the TPU's 24-row pad)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx)[:, :batch])
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy)[:, :batch])
    assert not np.asarray(jx)[:, batch:].any()


def test_sinc_matches_jax():
    x = np.random.RandomState(2).uniform(size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        objective_functions.sinc(torch.tensor(x)).numpy(),
        np.asarray(jax_objectives.sinc(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_normalization_helpers_match_jax():
    x = np.random.RandomState(3).standard_normal((30, 2))
    for name in ("zero_mean_unit_var_normalization", "zero_one_normalization"):
        got = getattr(base_model, name)(x)
        want = getattr(jax_base_model, name)(x)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_tree_helpers():
    tree = {"w": torch.ones(2, 3), "b": torch.ones(3, dtype=torch.float64)}
    assert pytree.tree_size(tree) == 9
    zeros = pytree.tree_zeros_like(tree)
    assert zeros["b"].dtype == torch.float64 and not zeros["w"].any()
    assert pytree.tree_cast(tree, torch.float16)["b"].dtype == torch.float16


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    words = [torch.tensor([c], dtype=torch.int64) for c in counter]
    got = fs.philox4x32_10(words, key)
    assert tuple(int(w) for w in got) == want


def test_philox_normals_pass_ks_test():
    z = fs.philox_normals(2**33 + 7, 5, 16, 2000, "cpu").numpy().ravel()
    assert np.isfinite(z).all()
    assert scipy.stats.kstest(z, "norm").pvalue > 1e-3
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01


def test_philox_normals_take_four_from_each_draw():
    """Elements 4q .. 4q + 3 are Box-Muller's cosine and sine of words
    (x, y), then (z, w), of draw q, computed here from the words in f64;
    the last draw partial (22 elements).  Tolerance: the f32 evaluation of
    the log, root and angle, at |z| <= 5.8."""
    seed, step, n, p = 2**35 + 3, 9, 5, 22
    z = fs.philox_normals(seed, step, n, p, "cpu")
    words = fs.philox4x32_10(
        (torch.arange(n)[:, None], step, torch.arange((p + 3) // 4)[None, :],
         fs.PURPOSE_NOISE), (seed & 0xFFFFFFFF, seed >> 32))
    u = [fs.bits_to_uniform(w).double() for w in words]
    want = []
    for first, second in ((0, 1), (2, 3)):
        radius = torch.sqrt(-2.0 * torch.log(u[first]))
        angle = 2.0 * np.pi * u[second]
        want += [radius * torch.cos(angle), radius * torch.sin(angle)]
    want = torch.stack(want, dim=-1).reshape(n, -1)[:, :p]
    assert z.shape == (n, p) and z.dtype == torch.float32
    torch.testing.assert_close(z.double(), want, rtol=0, atol=1e-5)


def test_philox_normals_elements_pick_from_the_full_call():
    """``elements=`` (the packed driver's ``noise_index`` keying, int32,
    in any order, with repeats) gives the full call's values of those
    elements."""
    full = fs.philox_normals(77, 3, 6, 64, "cpu")
    index = torch.tensor([63, 0, 5, 5, 17, 40, 2, 33, 62, 1],
                         dtype=torch.int32)
    got = fs.philox_normals(77, 3, 6, index.numel(), "cpu", index)
    assert torch.equal(got, full[:, index.long()])


def test_philox_normals_of_one_draw_are_uncorrelated():
    """The four normals that share a draw: |sample correlation| < 0.02
    (7 standard errors) over 2**17 draws, each one's mean and variance
    within 4 standard errors of N(0, 1)'s."""
    z = fs.philox_normals(2**40 + 11, 7, 2**9, 2**10, "cpu")
    quads = z.double().numpy().reshape(-1, 4)  # a row per draw
    n = quads.shape[0]
    assert n == 2**17
    corr = np.corrcoef(quads, rowvar=False)
    assert np.abs(corr[~np.eye(4, dtype=bool)]).max() < 0.02
    assert np.abs(quads.mean(axis=0)).max() < 4.0 / np.sqrt(n)
    assert np.abs(quads.var(axis=0) - 1.0).max() < 4.0 * np.sqrt(2.0 / n)


def test_philox_windows_are_uniform():
    counts = np.bincount(
        np.concatenate([fs.philox_windows(11, s, 500, 81, "cpu").numpy()
                        for s in range(20)]), minlength=81)
    assert counts.size == 81
    assert scipy.stats.chisquare(counts).pvalue > 1e-3


def test_bits_to_uniform_range():
    bits = torch.tensor([0, 255, 256, 0xFFFFFFFF], dtype=torch.int64)
    u = fs.bits_to_uniform(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [2.0**-24, 2.0**-24, 2.0**-23, 1.0]


def test_sampler_factory_matches_jax():
    sampler = sampling.Sampler.get_sampler(
        sampling.Sampler.SGHMC, cost_fn=lambda p: p["x"].sum(), mdecay=0.1)
    assert type(sampler).__name__ == "SGHMCSampler" and sampler.mdecay == 0.1
    for method in ("SGHMC", "SGLD", "SVGD", "PSGLD", "SGNHT",
                   "RelativisticSGHMC"):
        port, ref = sampling.Sampler[method], jax_sampling.Sampler[method]
        assert sampling.Sampler.is_supported(port) == \
            jax_sampling.Sampler.is_supported(ref)
        assert sampling.Sampler.is_burn_in_mcmc(port) == \
            jax_sampling.Sampler.is_burn_in_mcmc(ref)
    for bad in ("nope", 0):
        with pytest.raises(ValueError) as got:
            sampling.Sampler.get_sampler(bad, cost_fn=abs)
        with pytest.raises(ValueError) as want:
            jax_sampling.Sampler.get_sampler(bad, cost_fn=abs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        sampling.Sampler.get_sampler(sampling.Sampler.SGHMC, cost_fn=abs, x=1)
    with pytest.raises(ValueError) as want:
        jax_sampling.Sampler.get_sampler(
            jax_sampling.Sampler.SGHMC, cost_fn=abs, x=1)
    assert str(got.value).split("supported parameters")[0] == \
        str(want.value).split("supported parameters")[0]
    assert type(sampling.Sampler.get_sampler(
        sampling.Sampler.SGLD, cost_fn=abs)).__name__ == "SGLDSampler"
    assert type(sampling.Sampler.get_sampler(
        sampling.Sampler.SVGD, cost_fn=abs)).__name__ == "SVGDSampler"


def test_port_imports_no_jax():
    code = ("import sys, pysgmcmc_tpu_torch, pysgmcmc_tpu_torch.interop, "
            "pysgmcmc_tpu_torch.samplers.svgd, "
            "pysgmcmc_tpu_torch.ops.pairwise, "
            "pysgmcmc_tpu_torch.ops.svgd_streaming; "
            "sys.exit(int('jax' in sys.modules))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stderr or "jax was imported"


# every port module with docstring examples, as tests/test_doctests.py does
# for the JAX package
PORT_MODULES = [
    base_model, fs, numeric, objective_functions, pytree, sampling,
    stepsize_schedules, pysgmcmc_tpu_torch.interop,
    pysgmcmc_tpu_torch.models.architectures,
    pysgmcmc_tpu_torch.models.bayesian_neural_network,
    pysgmcmc_tpu_torch.samplers._adaptive, pysgmcmc_tpu_torch.samplers.sghmc,
    pysgmcmc_tpu_torch.samplers.sgld, pysgmcmc_tpu_torch.data_batches,
    pysgmcmc_tpu_torch.ops.slim_update, pysgmcmc_tpu_torch.ops.relativistic,
    pysgmcmc_tpu_torch.samplers.psgld, pysgmcmc_tpu_torch.samplers.sgnht,
    pysgmcmc_tpu_torch.samplers.relativistic_sghmc,
    pysgmcmc_tpu_torch.samplers.svgd, pysgmcmc_tpu_torch.ops.pairwise,
    pysgmcmc_tpu_torch.ops.svgd_streaming, tracing,
]


@pytest.mark.parametrize("module", PORT_MODULES, ids=lambda m: m.__name__)
def test_port_doctests(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0 and results.attempted > 0, module.__name__
