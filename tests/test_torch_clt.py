"""The MXU-CLT noise generator of the PyTorch port against the JAX package.

JAX's fused kernels draw their normals, by default on the chip, from
``_normal_clt``: ``z = bf16(u - 1/2) @ H_n * sqrt(12 / n)`` over groups of n
uniforms laid out by ``_block_etas``.  The port's plain generator
(``clt_normals``) is held against

(a) JAX's pieces exactly: the +-1 Hadamard matrices, and JAX's formula on
    shared uniforms mapped through ``unpack_fused``, for the 64-slot layout
    at depths 2-4 with one and two inputs and the 128-slot layout;
(b) JAX's interpret-mode kernels with ``noise_impl="hadamard_clt"``, whose
    zero random bits give ``-sqrt(12 n) / 2`` on lane 0 of every group:
    the port's plain B1, B2, B5-sgld and B6 read that pattern injected;
(c) its moments: mean 0, variance 1, excess kurtosis -1.2 / n, and the
    group's covariance that tells it from Box-Muller's normals;

and the drivers resolve ``noise_impl="auto"`` as JAX's do on the chip.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysgmcmc_tpu.ops import fused_step as jfs
from pysgmcmc_tpu.parallel import packed as jpacked
from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.parallel import packed
from pysgmcmc_tpu_torch.sampling import Sampler
from tests.test_torch_fused_step import (
    B1_PALLAS_TOL,
    B2_PALLAS_TOL,
    BATCH,
    EPS,
    H,
    LAYOUT,
    MDECAY,
    N_DATA,
    NAMES,
    PRIOR,
    assert_trees_close,
    to_flat,
    to_tree,
    windows,
    workload,
)
from tests.test_torch_sgld import (
    A_COEF,
    B5_PALLAS_TOL,
    B6_PALLAS_TOL,
    PALLAS_EPS,
)


#  (a) JAX's pieces --------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 128, 256])
def test_hadamard_matches_jax(n):
    """The transform of the identity is JAX's +-1 Sylvester-Hadamard
    matrix, exactly."""
    got = fs.fwht(torch.eye(n))
    want = np.asarray(jfs._hadamard_pm1(n), np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the transform of any input is the product with it
    x = torch.tensor(np.random.RandomState(n).standard_normal((3, n)),
                     dtype=torch.float32)
    np.testing.assert_allclose(fs.fwht(x).numpy(), x.numpy() @ want,
                               rtol=1e-5, atol=1e-5)


def _jax_clt(u):
    """JAX's ``_normal_clt`` on the uniforms ``u`` ``(c, rows, n)``."""
    n = u.shape[-1]
    z = jax.lax.dot_general(
        (jnp.asarray(u) - 0.5).astype(jnp.bfloat16).reshape(-1, n),
        jfs._hadamard_pm1(n), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return np.asarray(z.reshape(u.shape) * np.float32(np.sqrt(12.0 / n)))


def _jax_geometry(layout, c, rng):
    """Uniforms in ``_block_etas``'s arrays (each pair of matrix slabs, an
    odd last one, the vector rows) and the port's flat normals of JAX's
    formula on them, through ``unpack_fused``."""
    s, _ = fs.clt_slot(layout.hidden)
    n_mats = layout.depth - 1
    shapes = ([(c, s, 2 * s)] * (n_mats // 2)
              + [(c, s, s)] * (n_mats % 2) + [(c, 8, s)])
    us = [rng.uniform(0.0, 1.0, shape).astype(np.float32) for shape in shapes]
    zs = [_jax_clt(u) for u in us]
    mats = []
    for z in zs[:n_mats // 2]:
        mats += [z[:, :, :s], z[:, :, s:]]
    mats += zs[n_mats // 2:-1]
    big = np.concatenate([mats[0], zs[-1]], axis=1)  # W2 slab + vector rows
    tree = jfs.unpack_fused((big,) + tuple(mats[1:]), layout.hidden,
                            layout.n_inputs)
    want = fs.pack({k: torch.tensor(np.asarray(v)) for k, v in tree.items()},
                   layout)
    uniforms = torch.tensor(np.concatenate([u.reshape(c, -1) for u in us],
                                           axis=1))
    return uniforms, want


@pytest.mark.parametrize("n_inputs,hidden,depth", [
    (1, 50, 2), (1, 50, 3), (1, 50, 4), (2, 50, 2), (2, 50, 3), (2, 50, 4),
    (1, 100, 3)])
def test_plain_generator_matches_jax_formula(n_inputs, hidden, depth):
    layout = fs.FusedLayout(n_inputs, hidden, depth)
    uniforms, want = _jax_geometry(layout, 3, np.random.default_rng(depth))
    assert uniforms.shape[1] == fs.clt_slots(layout)
    got = fs.clt_normals(0, 0, 3, layout, "cpu", uniforms=uniforms)
    # the same bf16 operands and +-1 sums: f32 rounding of the sums apart
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _zero_pattern(n_chains, layout=LAYOUT):
    return fs.clt_normals(0, 0, n_chains, layout, "cpu",
                          uniforms=torch.zeros((n_chains,
                                                fs.clt_slots(layout))))


def test_zero_uniforms_give_jax_interpret_constant():
    """Zero uniforms: -sqrt(12 n) / 2 on lane 0 of every group, 0 elsewhere,
    on the live parameters ``_block_etas`` puts there (depth 3: W2 and W3
    share 128-lane groups, so W3 gets nothing)."""
    z = to_tree(_zero_pattern(2))
    c128, c64 = -math.sqrt(12 * 128) / 2, -math.sqrt(12 * 64) / 2
    want = {k: np.zeros_like(v) for k, v in z.items()}
    want["w2"][:, :, 0] = c128
    want["b2"][:, 0] = c128
    want["w1"][:, 0] = c64
    want["b1"][:, 0] = c64
    want["w4"][:, 0] = c64
    want["b4"][:, 0] = c64
    for k in z:
        np.testing.assert_allclose(z[k], want[k], rtol=1e-6, err_msg=k)


#  (b) against JAX's interpret-mode kernels with noise_impl="hadamard_clt" --

def _clt_stream(k, n):
    """The zero-bit CLT stream: its pattern every step, window 0."""
    return (_zero_pattern(n)[None].repeat(k, 1, 1),
            torch.zeros((k, n), dtype=torch.int32))


def test_clt_burnin_matches_pallas_kernel():
    n, k = 4, 3
    x, y, st = workload(n, seed=31)
    xw, yw = windows(x, y)
    out = jfs.fused_bnn_multistep_burnin(
        *[jfs.pack_fused(st[name]) for name in NAMES],
        *jfs.data_windows(x, y, BATCH), EPS, 0, mdecay=MDECAY,
        scale_grad=float(N_DATA), prior_scale=PRIOR, batch_size=BATCH,
        n_data=N_DATA, block_chains=n, state_dtype=jnp.float32, k_steps=k,
        noise_impl="hadamard_clt", interpret=True)
    noise, widx = _clt_stream(k, n)
    got = fs.fused_bnn_multistep_burnin_ref(
        *[to_flat(st[name]) for name in NAMES], xw, yw, EPS, 0,
        mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, k_steps=k, noise=noise, widx=widx)
    for name, flat, o in zip(NAMES + ("minv",), got[:6], out[:6]):
        assert_trees_close(to_tree(flat), jfs.unpack_fused(o, H),
                           "B2 clt " + name, **B2_PALLAS_TOL[name])
    np.testing.assert_allclose(got[6].numpy(), np.asarray(out[6]),
                               rtol=2e-2)


def test_clt_sampling_matches_pallas_kernel():
    n, k = 2, 3
    x, y, st = workload(n, seed=32)
    xw, yw = windows(x, y)
    theta, v, cost = jfs.fused_bnn_multistep(
        jfs.pack_fused(st["theta"]), jfs.pack_fused(st["v"]),
        jfs.pack_fused(st["minv"]), *jfs.data_windows(x, y, BATCH), EPS, 0,
        mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, block_chains=n,
        state_dtype=jnp.float32, k_steps=k, noise_impl="hadamard_clt",
        interpret=True)
    noise, widx = _clt_stream(k, n)
    got = fs.fused_bnn_multistep_ref(
        to_flat(st["theta"]), to_flat(st["v"]), to_flat(st["minv"]), xw, yw,
        EPS, 0, mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
        batch_size=BATCH, n_data=N_DATA, k_steps=k, noise=noise, widx=widx)
    assert_trees_close(to_tree(got[0]), jfs.unpack_fused(theta, H),
                       "B1 clt theta", **B1_PALLAS_TOL["theta"])
    assert_trees_close(to_tree(got[1]), jfs.unpack_fused(v, H), "B1 clt v",
                       **B1_PALLAS_TOL["v"])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(cost), rtol=2e-2)


def test_clt_sgld_kernels_match_pallas_kernels():
    n, k = 2, 3
    names = ("theta", "tau", "g", "v_hat")
    x, y, st = workload(n, seed=33)
    xw, yw = windows(x, y)
    jw = jfs.data_windows(x, y, BATCH)
    common = dict(a_coef=A_COEF, scale_grad=float(N_DATA), prior_scale=PRIOR,
                  batch_size=BATCH, n_data=N_DATA, k_steps=k)
    noise, widx = _clt_stream(k, n)
    out = jfs.fused_bnn_multistep_burnin_sgld(
        *[jfs.pack_fused(st[name]) for name in names], *jw, PALLAS_EPS, 0,
        block_chains=n, noise_impl="hadamard_clt", interpret=True, **common)
    got = fs.fused_bnn_multistep_burnin_sgld_ref(
        *[to_flat(st[name]) for name in names], xw, yw, PALLAS_EPS, 0,
        noise=noise, widx=widx, **common)
    for name, flat, o in zip(names + ("minv",), got[:5], out[:5]):
        assert_trees_close(to_tree(flat), jfs.unpack_fused(o, H),
                           "B6 clt " + name, **B6_PALLAS_TOL[name])
    theta, cost = jfs.fused_bnn_multistep_sgld(
        jfs.pack_fused(st["theta"]), jfs.pack_fused(st["minv"]), *jw,
        PALLAS_EPS, 0, block_chains=n, noise_impl="hadamard_clt",
        interpret=True, **common)
    got = fs.fused_bnn_multistep_sgld_ref(
        to_flat(st["theta"]), to_flat(st["minv"]), xw, yw, PALLAS_EPS, 0,
        noise=noise, widx=widx, **common)
    assert_trees_close(to_tree(got[0]), jfs.unpack_fused(theta, H),
                       "B5-sgld clt theta", **B5_PALLAS_TOL["theta"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(cost), rtol=2e-2)


#  (c) moments -------------------------------------------------------------------

# the layout whose groups are ``group`` lanes wide, and the columns
# (lo, hi) of its flat vector those groups fill
MOMENT_LAYOUTS = {64: (fs.FusedLayout(1, 50, 2), None),
                  128: (LAYOUT, ("w2", "w4")),
                  256: (fs.FusedLayout(1, 100, 3), ("w2", "w4"))}


@pytest.mark.parametrize("group", [128, 64, 256])
def test_moments(group):
    """2^21 normals of the 128-lane groups (W2, W3 and their biases at
    depth 3), of the 64-lane ones (depth 2: W2 and the vector rows) or of
    the 256-lane ones (the 128-slot layout at H = 100): mean, variance and
    excess kurtosis within 4 standard errors of 0, 1 and -1.2 / n
    (Irwin-Hall's).  (The kurtosis bound does not tell -1.2 / n from 0:
    :func:`test_group_energy` does.)"""
    layout, cols = MOMENT_LAYOUTS[group]
    off = layout.offsets()
    lo, hi = ((off[cols[0]][0], off[cols[1]][0]) if cols
              else (0, layout.n_params))
    want_n = 1 << 21
    draws, step = [], 0
    while sum(d.numel() for d in draws) < want_n:
        z = fs.clt_normals(2**40 + 3, step, 256, layout, "cpu")
        draws.append(z[:, lo:hi].reshape(-1))
        step += 1
    x = torch.cat(draws)[:want_n].double()
    n = x.numel()
    mean, var = float(x.mean()), float(x.var())
    kurt = float(((x - x.mean()) ** 4).mean() / x.var() ** 2 - 3.0)
    assert abs(mean) < 4 / math.sqrt(n)
    assert abs(var - 1.0) < 4 * math.sqrt(2.0 / n)
    assert abs(kurt + 1.2 / group) < 4 * math.sqrt(24.0 / n)


def _energy_ratios(z, emap, width):
    """``(E - m)^2 / (m (2 - 1.2 m / n))`` of every group: ``E`` the sum of
    the squares of its ``m`` live normals (the flat elements of its row of
    ``emap``) in ``z`` ``(chains, P)``, ``n = width``."""
    keep = emap >= 0
    m = keep.sum(1).double()
    sq = torch.where(keep, z[:, emap.clamp_min(0)].double() ** 2, 0.0)
    energy = sq.sum(-1)
    return ((energy - m) ** 2 / (m * (2.0 - 1.2 * m / width))).reshape(-1)


@pytest.mark.parametrize("group", [64, 128, 256])
def test_group_energy(group):
    """The n normals of a group are one +-1 Hadamard mix of n uniforms, so
    z_j^2 and z_k^2 (j != k) covary by -1.2 / n (Box-Muller's: by 0; the
    same -1.2 / n as each normal's excess kurtosis), and the sum of the
    squares of a group's m live normals has variance m (2 - 1.2 m / n)
    against Box-Muller's 2 m (about 1.9 times more here).  Over more than
    10^4 groups, pooled: the CLT normals' mean ratio lies within 4 standard
    errors of 1, and Box-Muller's, drawn for the same elements, does
    not."""
    layout, _ = MOMENT_LAYOUTS[group]
    emap = torch.cat([e[(e >= 0).any(1)] for _, e in fs._clt_sections(layout)
                      if e.shape[1] == group])
    ratios = {"hadamard_clt": [], "box_muller": []}
    step = 0
    while sum(r.numel() for r in ratios["hadamard_clt"]) < 10_000:
        for impl in ratios:
            z = fs._step_normals(impl, 2**40 + 5, step, 64, layout, "cpu")
            ratios[impl].append(_energy_ratios(z, emap, group))
        step += 1
    for impl, parts in ratios.items():
        r = torch.cat(parts)
        se = float(r.std()) / math.sqrt(r.numel())
        within = abs(float(r.mean()) - 1.0) < 4 * se
        assert within == (impl == "hadamard_clt"), (impl, float(r.mean()),
                                                     se)


#  The stream, the knob and the default ------------------------------------------

def test_clt_chunked_launches_equal_one_launch_and_differ_from_box_muller():
    n, k = 2, 2
    x, y, st = workload(n, seed=34)
    xw, yw = windows(x, y)
    state = [to_flat(st[name]) for name in ("theta", "v", "minv")]
    kw = dict(mdecay=MDECAY, scale_grad=float(N_DATA), prior_scale=PRIOR,
              batch_size=BATCH, n_data=N_DATA, noise_impl="hadamard_clt")
    whole = fs.fused_bnn_multistep(*state, xw, yw, EPS, 77, k_steps=2 * k,
                                   step0=5, **kw)
    first = fs.fused_bnn_multistep(*state, xw, yw, EPS, 77, k_steps=k,
                                   step0=5, **kw)
    second = fs.fused_bnn_multistep(first[0], first[1], state[2], xw, yw,
                                    EPS, 77, k_steps=k, step0=5 + k, **kw)
    for a, b in zip(whole, second):
        assert torch.equal(a, b)
    bm = fs.fused_bnn_multistep(*state, xw, yw, EPS, 77, k_steps=2 * k,
                                step0=5, **dict(kw, noise_impl="box_muller"))
    assert not torch.equal(whole[0], bm[0])
    # injected noise is Box-Muller's test input, as in JAX
    with pytest.raises(ValueError, match="injected noise"):
        fs.fused_bnn_multistep(*state, xw, yw, EPS, 77, k_steps=1,
                               noise=torch.zeros((1, n, LAYOUT.n_params)),
                               **kw)


@pytest.mark.parametrize("noise_impl", ["auto", "box_muller",
                                        "hadamard_clt"])
@pytest.mark.parametrize("pair_dots", [False, True])
def test_resolve_noise_impl_matches_jax_on_the_chip(noise_impl, pair_dots):
    assert packed.resolve_noise_impl(noise_impl, pair_dots) == \
        jpacked.resolve_noise_impl(noise_impl, pair_dots, interpret=False)
    assert packed.resolve_noise_impl("zero", pair_dots) == "zero"


@pytest.mark.parametrize("driver", ["sample_chain_lanes", "burnin_chain_lanes",
                                    "sample_chain_packed",
                                    "sample_chain_stacked"])
def test_box_muller_drivers_refuse_clt(driver):
    """The lanes, packed and stacked drivers have Box-Muller only, as JAX's:
    ``'auto'`` is Box-Muller there and ``'hadamard_clt'`` a ValueError."""
    assert packed.box_muller_noise(driver, "auto") == "box_muller"
    assert packed.box_muller_noise(driver, "zero") == "zero"
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.samplers import SGHMCSampler

    init_fn, _ = dense_network(1, units=(4, 4, 4), device="cpu")
    sampler = SGHMCSampler(lambda p, b: torch.zeros(()),
                           stepsize_schedule=0.01)
    states = sampler.init(init_fn(torch.Generator().manual_seed(0), (2,)))
    with pytest.raises(ValueError, match="hadamard_clt"):
        getattr(packed, driver)(sampler, states, torch.Generator(), 1,
                                noise_impl="hadamard_clt")


def test_clt_bnn_trains_on_the_cpu():
    """The fused BNN on its default generator, the CLT (a few steps of 2
    chains): finite predictions, and other samples than Box-Muller's from
    the same seed."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (40, 1)).astype(np.float32)
    y = np.sinc(x[:, 0] * 10 - 5).astype(np.float32)
    runs = {}
    for noise_impl in ("auto", "box_muller"):
        bnn = BayesianNeuralNetwork(
            sampling_method=Sampler.SGHMC, network="dense",
            step_impl="fused", units=(8, 8, 8), n_chains=2, n_nets=2,
            burn_in_steps=4, sample_steps=2, n_iters=6, log_every=None,
            noise_impl=noise_impl, device="cpu")
        bnn.train(x, y)
        mean, var = bnn.predict(x)
        assert np.isfinite(mean).all() and np.isfinite(var).all()
        runs[noise_impl] = bnn.samples["w2"]
    assert not torch.equal(runs["auto"], runs["box_muller"])
