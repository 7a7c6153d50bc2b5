"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel (B1, B2, B3, B4-sgld, B4-psgld, B4-sgnht, B4-rsghmc, B5-sgld,
B5-psgld, B5-sgnht, B5-rsghmc, B6; the slim kernels B7, B8-sgld, B8-psgld,
B8-rsghmc, B8-sgnht, B9-sghmc and B9-sgld; the SVGD transport B11;
FusedSGHMC's B10, B7 with its mask and the stacked tree's B7') is held
against its plain PyTorch version on the same inputs, from the state a
200-step burn-in leaves, under injected noise and windows and under the
Philox stream, with the tolerance
``chip_smoke.py`` uses: 2e-4 of the largest value in each chain's row of
each output (summation order and libm ulps, carried through the steps).
The bf16-state instantiations are held over k <= 3 steps with one bf16 ulp
of each bf16 value per step on top (a value whose f32 result straddles a
rounding boundary rounds one ulp apart) and the share of differing bf16
values beside a CPU witness (``chip_smoke._compare``), and under bf16
state two launches of k steps must equal one of 2k bit for bit (B5-sgnht
at f32 state: one launch of k steps equals k of one step, xi included);
B1, B2, B5-sgld and B6 are also held at hidden width 100 (depth 3), whose
state lives in device memory.  Every fused kernel's MXU-CLT instantiation
(``noise_impl="hadamard_clt"``) is held the same way on the Philox stream,
at f32 and bf16 state and at width 100, and must draw another stream than
Box-Muller's; every paired instantiation (``pair_dots=True``) against its
plain version at f32 and bf16 state, and against the unpaired kernel bit
for bit at f32 state.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, dense_network
from pysgmcmc_tpu_torch.ops import fused_step as fs
from pysgmcmc_tpu_torch.ops import _build, pairwise
from pysgmcmc_tpu_torch.ops import fused_update as fu
from pysgmcmc_tpu_torch.ops import slim_update as su
from pysgmcmc_tpu_torch.ops import svgd_streaming as ss
from pysgmcmc_tpu_torch.ops.relativistic import sample_relativistic_momentum
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_fused,
    make_pack_spec,
    pack_mask,
    pack_tree,
    sample_chain_fused,
    sample_chain_lanes,
    sample_chain_packed,
    sample_chain_stacked,
)
from pysgmcmc_tpu_torch.samplers import (
    FusedSGHMC,
    PSGLDSampler,
    RelativisticSGHMCSampler,
    SGHMCSampler,
    SGLDSampler,
    SGNHTSampler,
)
from pysgmcmc_tpu_torch.sampling import Sampler

REL_TOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


def _data(gen):
    x = torch.rand((100, 1), generator=gen, device=gen.device)
    return x, torch.sinc(10 * x[:, 0] - 5)


def _state(device, n, h=50, depth=3, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    init, _ = dense_network(1, units=(h,) * depth, device=device)
    lay = fs.FusedLayout(1, h, depth)
    theta = fs.pack(init(gen, (n,)), lay)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(theta.shape, generator=gen,
                                           device=device)

    x_win, y_win = fs.data_windows(*_data(gen), 20)
    state = {"theta": theta, "v": uniform(-1e-3, 1e-3),
             "tau": uniform(1.0, 5.0), "g": uniform(-1.0, 1.0),
             "v_hat": uniform(1.0, 5.0), "minv": uniform(0.2, 1.2)}
    return lay, state, x_win, y_win, gen


def _burned_in(sampler_cls, x, y, n):
    """The packed state after 200 burn-in steps at eps 0.01 from He-normal
    weights (through the B2 / B6 driver), as the main path hands it on."""
    init, _ = dense_network(1, device=x.device)
    gen = torch.Generator(device=x.device).manual_seed(0)
    lay = fs.FusedLayout(1, 50, 3)
    sampler = sampler_cls(lambda p, b: None, stepsize_schedule=0.01,
                          scale_grad=100.0,
                          gaussian_prior_scale=1.0 / (lay.n_params * 100))
    st = burnin_chain_fused(sampler, sampler.init(init(gen, (n,))), gen, 200,
                            x, y, state_dtype=torch.float32)
    state = {"theta": fs.pack(st.position, lay)}
    state.update(zip(("tau", "g", "v_hat", "minv"),
                     (fs.pack(leaf, lay) for leaf in st.stats)))
    if sampler_cls is SGHMCSampler:
        state["v"] = fs.pack(st.momentum, lay)
    return lay, state


def _row_rel_err(got, want):
    """The largest |got - want| in each chain's row over the row's largest
    |want| (one row for the (n, 1) costs), maximised over the rows."""
    if want.shape[1] == 1:
        got, want = got.reshape(1, -1), want.reshape(1, -1)
    return float(((got - want).abs().amax(1) / want.abs().amax(1)).max())


# kernel -> (wrapper, plain version, sampler, state arguments, stepsize); the
# one-step kernels (B3, B4-sgld) take gathered rows instead of windows.
# SGLD moves theta by eps * minv * g, not SGHMC's eps**2 * minv * g: from
# the burned-in state (minv up to ~1e3) at eps = 0.01 its chains amplify
# rounding beyond the tolerance within 8 steps, in the plain version alone,
# so the SGLD kernels run at eps = 1e-3.
KERNELS = {
    "B1": (fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref, SGHMCSampler,
           ("theta", "v", "minv"), 0.01),
    "B2": (fs.fused_bnn_multistep_burnin, fs.fused_bnn_multistep_burnin_ref,
           SGHMCSampler, ("theta", "v", "tau", "g", "v_hat"), 0.01),
    "B3": (fs.fused_bnn_step, fs.fused_bnn_step_ref, SGHMCSampler,
           ("theta", "v", "minv"), 0.01),
    "B4-sgld": (fs.fused_bnn_step_sgld, fs.fused_bnn_step_sgld_ref,
                SGLDSampler, ("theta", "minv"), 1e-3),
    "B5-sgld": (fs.fused_bnn_multistep_sgld, fs.fused_bnn_multistep_sgld_ref,
                SGLDSampler, ("theta", "minv"), 1e-3),
    "B6": (fs.fused_bnn_multistep_burnin_sgld,
           fs.fused_bnn_multistep_burnin_sgld_ref, SGLDSampler,
           ("theta", "tau", "g", "v_hat"), 1e-3),
}


def _launches(fn, stream):
    """The launches of the instantiation a stream launches."""
    return fs.variant_launches(
        fn, "hadamard_clt" if stream == "clt" else "box_muller")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("stream", ["injected", "philox", "clt"])
def test_kernel_matches_plain_version(kernel, stream, cuda_device):
    n, k = 64, 8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, y = _data(gen)
    fn, ref, sampler_cls, names, eps = KERNELS[kernel]
    lay, st = _burned_in(sampler_cls, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    one_step = kernel in ("B3", "B4-sgld")
    extra = {}
    if one_step:
        widx = torch.randint(0, x_win.shape[0], (n,), generator=gen,
                             device=cuda_device)
        x_win, y_win = fs.gather_batch(x_win, y_win, widx)
        shape = (n, lay.n_params)
        extra["step"] = 2**32 - 1
    else:
        shape = (k, n, lay.n_params)
        extra.update(k_steps=k, step0=2**32 - 3)  # the counter wraps
    if stream == "injected":
        extra.pop("step", None)
        extra.pop("step0", None)
        extra["noise"] = torch.randn(shape, generator=gen, device=cuda_device)
        if not one_step:
            extra["widx"] = torch.randint(
                0, x_win.shape[0], (k, n), generator=gen, device=cuda_device,
                dtype=torch.int32)
    if stream == "clt":
        extra["noise_impl"] = "hadamard_clt"
    args = [st[name] for name in names] + [x_win, y_win, eps, 2**63 + 5]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  **extra)
    before = _launches(fn, stream)
    got = fn(*args, **common)
    assert _launches(fn, stream) == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL


# slim kernel -> (wrapper, plain version, sampler, operands, stepsize)
SLIM = {
    "B7": (su.slim_sghmc_update, su.slim_sghmc_update_ref, SGHMCSampler,
           ("theta", "v", "grad", "minv"), 0.01),
    "B8-sgld": (su.slim_sgld_update, su.slim_sgld_update_ref, SGLDSampler,
                ("theta", "grad", "minv"), 1e-3),
    "B9-sghmc": (su.slim_sghmc_burnin_update, su.slim_sghmc_burnin_update_ref,
                 SGHMCSampler, ("theta", "v", "tau", "g", "v_hat", "grad"),
                 0.01),
    "B9-sgld": (su.slim_sgld_burnin_update, su.slim_sgld_burnin_update_ref,
                SGLDSampler, ("theta", "tau", "g", "v_hat", "grad"), 1e-3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(SLIM))
@pytest.mark.parametrize("stream", ["injected", "philox", "philox-per-chain"])
def test_slim_kernel_matches_plain_version(kernel, stream, cuda_device):
    n = 64
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, y = _data(gen)
    fn, ref, sampler_cls, names, eps = SLIM[kernel]
    lay, st = _burned_in(sampler_cls, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    widx = fs.philox_windows(3, 0, n, x_win.shape[0], cuda_device)
    st["grad"] = fs._fwd_bwd(st["theta"], lay, x_win[widx][:, :, None],
                             y_win[widx], 1.0 / 20, 1.0 / 100)[1]
    extra = {"step": 2**32 - 1}
    if stream == "injected":
        extra = {"noise": torch.randn(st["theta"].shape, generator=gen,
                                      device=cuda_device)}
    elif stream == "philox-per-chain":
        eps = eps * (0.5 + torch.rand(n, generator=gen, device=cuda_device))
    args = [st[name] for name in names] + [None, eps, 2**63 + 5]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  **extra)
    before = fn.launches
    got = fn(*args, **common)
    assert fn.launches == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    got, want = (out if isinstance(out, tuple) else (out,)
                 for out in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL


# the slim kernels of the samplers without a mass matrix -> (wrapper, plain
# version, rule keywords)
SLIM_B8 = {
    "B8-psgld": (su.slim_psgld_update, su.slim_psgld_update_ref,
                 dict(alpha=0.99, lambda_reg=1e-5, scale_grad=100.0)),
    "B8-rsghmc": (su.slim_rsghmc_update, su.slim_rsghmc_update_ref,
                  dict(d_coef=1.0, bhat=0.0, mass=1.0, speed_of_light=1.0)),
    "B8-sgnht": (su.slim_sgnht_update, su.slim_sgnht_update_ref,
                 dict(a_diff=1.0, scale_grad=100.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(SLIM_B8))
@pytest.mark.parametrize("stream", ["injected", "philox", "philox-per-chain"])
def test_slim_b8_kernel_matches_plain_version(kernel, stream, cuda_device):
    """From the burned-in theta and its gradient, with pSGLD's accumulator
    at g^2, RSGHMC's momentum from the relativistic marginal and SGNHT's
    momentum from N(0, 1) with one xi per chain around 1."""
    n = 64
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, y = _data(gen)
    fn, ref, rule = SLIM_B8[kernel]
    lay, st = _burned_in(SGHMCSampler, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    widx = fs.philox_windows(3, 0, n, x_win.shape[0], cuda_device)
    theta = st["theta"]
    grad = fs._fwd_bwd(theta, lay, x_win[widx][:, :, None], y_win[widx],
                       1.0 / 20, 1.0 / 100)[1]
    if kernel == "B8-psgld":
        args = [theta, grad * grad, grad, None]
    elif kernel == "B8-rsghmc":
        args = [theta, sample_relativistic_momentum(gen, theta.shape),
                grad, None]
    else:
        args = [theta, torch.randn(theta.shape, generator=gen,
                                   device=cuda_device), grad, None,
                1.0 + 0.1 * torch.randn(n, generator=gen, device=cuda_device)]
    eps = 1e-3
    extra = {"step": 2**32 - 1}
    if stream == "injected":
        extra = {"noise": torch.randn(theta.shape, generator=gen,
                                      device=cuda_device)}
    elif stream == "philox-per-chain":
        eps = eps * (0.5 + torch.rand(n, generator=gen, device=cuda_device))
    common = dict(prior_scale=1.0 / (lay.n_params * 100), **rule, **extra)
    before = fn.launches
    got = fn(*args, eps, 2**63 + 5, **common)
    assert fn.launches == before + 1
    want = ref(*args, eps, 2**63 + 5, **common)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL


# the fused kernels of the samplers without a mass matrix -> (wrapper, plain
# version, rule keywords, stepsize); they run from the burned-in theta with
# pSGLD's accumulator at g^2, momenta from N(0, 1) and one xi per chain
FUSED_NEW = {
    "B4-psgld": (fs.fused_bnn_step_psgld, fs.fused_bnn_step_psgld_ref,
                 dict(alpha=0.99, lambda_reg=1e-5, scale_grad=100.0), 1e-4),
    "B4-sgnht": (fs.fused_bnn_step_sgnht, fs.fused_bnn_step_sgnht_ref,
                 dict(a_diff=1.0, scale_grad=100.0), 3e-4),
    "B4-rsghmc": (fs.fused_bnn_step_rsghmc, fs.fused_bnn_step_rsghmc_ref,
                  dict(mass=1.0, speed_of_light=1.0, d_coef=1.0), 1e-3),
    "B5-psgld": (fs.fused_bnn_multistep_psgld,
                 fs.fused_bnn_multistep_psgld_ref,
                 dict(alpha=0.99, lambda_reg=1e-5, scale_grad=100.0), 1e-4),
    "B5-sgnht": (fs.fused_bnn_multistep_sgnht,
                 fs.fused_bnn_multistep_sgnht_ref,
                 dict(a_diff=1.0, scale_grad=100.0), 3e-4),
    "B5-rsghmc": (fs.fused_bnn_multistep_rsghmc,
                  fs.fused_bnn_multistep_rsghmc_ref,
                  dict(mass=1.0, speed_of_light=1.0, d_coef=1.0), 1e-3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(FUSED_NEW))
@pytest.mark.parametrize("stream", ["injected", "philox", "clt"])
def test_fused_kernel_without_mass_matches_plain_version(kernel, stream,
                                                         cuda_device):
    n, k = 64, 8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, y = _data(gen)
    fn, ref, rule, eps = FUSED_NEW[kernel]
    lay, st = _burned_in(SGHMCSampler, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    theta = st["theta"]
    widx = fs.philox_windows(3, 0, n, x_win.shape[0], cuda_device)
    grad = fs._fwd_bwd(theta, lay, x_win[widx][:, :, None], y_win[widx],
                       1.0 / 20, 1.0 / 100)[1]
    if kernel.endswith("psgld"):
        args = [theta, grad * grad]
    else:
        args = [theta, torch.randn(theta.shape, generator=gen,
                                   device=cuda_device)]
    if kernel.endswith("sgnht"):
        args.append(1.0 + 0.1 * torch.randn(n, generator=gen,
                                            device=cuda_device))
    one_step = kernel.startswith("B4")
    extra = {}
    if one_step:
        x_win, y_win = fs.gather_batch(x_win, y_win, widx)
        shape = (n, lay.n_params)
        extra["step"] = 2**32 - 1
    else:
        shape = (k, n, lay.n_params)
        extra.update(k_steps=k, step0=2**32 - 3)  # the counter wraps
    if stream == "injected":
        extra = {key: val for key, val in extra.items() if key == "k_steps"}
        extra["noise"] = torch.randn(shape, generator=gen, device=cuda_device)
        if not one_step:
            extra["widx"] = torch.randint(
                0, x_win.shape[0], (k, n), generator=gen, device=cuda_device,
                dtype=torch.int32)
    if stream == "clt":
        extra["noise_impl"] = "hadamard_clt"
    args += [x_win, y_win, eps, 2**63 + 5]
    common = dict(prior_scale=1.0 / (lay.n_params * 100), **rule, **extra)
    before = _launches(fn, stream)
    got = fn(*args, **common)
    assert _launches(fn, stream) == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a.reshape(len(a), -1), b.reshape(len(b), -1)) \
            <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("sampler_cls,kw", [
    (PSGLDSampler, dict(scale_grad=100.0)),
    (SGNHTSampler, dict(scale_grad=100.0)),
    (RelativisticSGHMCSampler, {})])
def test_one_step_driver_matches_multistep_driver_without_mass(
        sampler_cls, kw, cuda_device):
    """k launches of B4-psgld / B4-sgnht / B4-rsghmc follow one B5 launch of
    k steps from the same state and seed."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    init, _ = dense_network(1, device=cuda_device)
    sampler = sampler_cls(lambda p, b: None, stepsize_schedule=1e-4,
                          gaussian_prior_scale=1e-4, **kw)
    gen = torch.Generator(cuda_device).manual_seed(0)
    states = sampler.init(init(gen, (32,)), gen)
    runs = [sample_chain_fused(
        sampler, states, torch.Generator(cuda_device).manual_seed(3), 2, x, y,
        keep_every=5, multistep=multistep) for multistep in (True, False)]
    for key, want in runs[0][1].items():
        got = runs[1][1][key]
        assert torch.isfinite(want).all(), key
        assert float((got - want).abs().max()) <= \
            REL_TOL * float(want.abs().max()), key
    assert int(runs[0][0].step) == int(runs[1][0].step) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("sampler_cls", [SGHMCSampler, SGLDSampler])
def test_one_step_driver_matches_multistep_driver(sampler_cls, cuda_device):
    """k launches of B3 / B4-sgld follow one B1 / B5-sgld launch of k steps
    from the same state and seed (same windows, same noise)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    init, _ = dense_network(1, device=cuda_device)
    eps = 0.01 if sampler_cls is SGHMCSampler else 1e-3  # as KERNELS
    sampler = sampler_cls(lambda p, b: None, stepsize_schedule=eps,
                          scale_grad=100.0, gaussian_prior_scale=1e-4)
    states = sampler.init(init(torch.Generator(cuda_device).manual_seed(0),
                               (32,)))
    states = states._replace(step=states.step + 50)
    runs = [sample_chain_fused(
        sampler, states, torch.Generator(cuda_device).manual_seed(3), 2, x, y,
        keep_every=5, multistep=multistep) for multistep in (True, False)]
    for key, want in runs[0][1].items():
        got = runs[1][1][key]
        assert torch.isfinite(want).all(), key
        assert float((got - want).abs().max()) <= \
            REL_TOL * float(want.abs().max()), key
    assert int(runs[0][0].step) == int(runs[1][0].step) == 60


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    lay, st, x_win, y_win, _ = _state(cuda_device, 4)
    theta = st["theta"]
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_bnn_multistep(theta.t().contiguous().t(), st["v"],
                               st["minv"], x_win, y_win, 0.01, 1)
    with pytest.raises(ValueError, match="match theta"):
        fs.fused_bnn_multistep(theta, st["v"].cpu(), st["minv"], x_win,
                               y_win, 0.01, 1)
    with pytest.raises(ValueError, match="match theta"):  # f32 state wanted
        fs.fused_bnn_multistep(theta, st["v"].bfloat16(), st["minv"], x_win,
                               y_win, 0.01, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        su.slim_sghmc_update(theta, st["v"].half(), st["g"], st["minv"],
                             None, 0.01, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["SGHMC", "SGLD"])
def test_bnn_trains_on_the_card(method, cuda_device):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    if method == "SGHMC":
        burnin, sampling = fs.fused_bnn_multistep_burnin, fs.fused_bnn_multistep
    else:
        burnin = fs.fused_bnn_multistep_burnin_sgld
        sampling = fs.fused_bnn_multistep_sgld
    # the fused path's default generator is the CLT's
    fs.placements.clear()
    bnn = BayesianNeuralNetwork(
        sampling_method=Sampler[method], network="dense", step_impl="fused",
        n_chains=256, n_nets=512, burn_in_steps=1500, sample_steps=50,
        n_iters=1600)  # on the card by default
    bnn.train(x, y)
    assert fs.variant_launches(burnin, "hadamard_clt") == 3  # log_every 512
    assert fs.variant_launches(sampling, "hadamard_clt") == 2
    assert bnn.samples["w2"].is_cuda and bnn.samples["w2"].shape[0] == 512
    mean, var = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    truth = np.sinc(np.linspace(0.0, 1.0, 50) * 10 - 5)
    assert np.mean((mean - truth) ** 2) < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["SGHMC", "SGLD"])
def test_lanes_bnn_trains_on_the_card(method, cuda_device):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    if method == "SGHMC":
        burnin, sampling = su.slim_sghmc_burnin_update, su.slim_sghmc_update
    else:
        burnin, sampling = su.slim_sgld_burnin_update, su.slim_sgld_update
    burnin.launches = sampling.launches = 0
    bnn = BayesianNeuralNetwork(
        sampling_method=Sampler[method], network="reference",
        step_impl="lanes", n_chains=256, n_nets=512, burn_in_steps=1500,
        sample_steps=50, n_iters=1600)  # on the card by default
    bnn.train(x, y)
    assert burnin.launches == 1500  # one launch per step
    assert sampling.launches == 100
    assert bnn.samples["w1"].is_cuda and bnn.samples["w1"].shape == (512, 1,
                                                                        50)
    mean, var = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    truth = np.sinc(np.linspace(0.0, 1.0, 50) * 10 - 5)
    assert np.mean((mean - truth) ** 2) < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernel,eps", [
    ("PSGLD", su.slim_psgld_update, 1e-3),
    ("RelativisticSGHMC", su.slim_rsghmc_update, 1e-3),
    ("SGNHT", su.slim_sgnht_update, 3e-4)])
def test_lanes_bnn_without_burn_in_trains_on_the_card(method, kernel, eps,
                                                      cuda_device):
    """Burn-in is discarded steps of the same kernel: one launch a step."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    kernel.launches = 0
    bnn = BayesianNeuralNetwork(
        sampling_method=Sampler[method], network="reference",
        step_impl="lanes", n_chains=256, n_nets=512, burn_in_steps=1500,
        sample_steps=50, n_iters=1600, stepsize_schedule=eps)
    bnn.train(x, y)
    assert kernel.launches == 1600
    assert bnn.samples["w1"].is_cuda and bnn.samples["w1"].shape == (512, 1,
                                                                        50)
    mean, var = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])
    assert np.isfinite(mean).all() and np.isfinite(var).all()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("h", [8, 50, 64, 114])
def test_fused_placement_is_device_exactly_where_too_wide(depth, h,
                                                          cuda_device):
    """Fault C1, repaired: a launch keeps the state in shared memory exactly
    where the library's fused_step_smem_bytes fits a block, else in device
    memory, for every fused kernel; the flagship's network fits them all,
    and a launch is counted under the placement it took."""
    lib = _build.load("fused_step")
    for n_inputs, batch in ((1, 20), (3, 7)):
        lay = fs.FusedLayout(n_inputs, h, depth)
        for kernel_id in range(1, 13):
            need = lib.fused_step_smem_bytes(kernel_id, lay.n_params,
                                             n_inputs, h, depth, batch)
            want = "device" if need > _build.MAX_SMEM_BYTES else "shared"
            assert fs.fused_placement(kernel_id, lay, batch) == want
    if (h, depth) == (50, 3):
        assert {fs.fused_placement(k, fs.FusedLayout(1, 50, 3), 20)
                for k in range(1, 13)} == {"shared"}
    if (h, depth) == (114, 4):
        lay, st, x_win, y_win, _ = _state(cuda_device, 2, h=114, depth=4)
        fs.placements.clear()
        out = fs.fused_bnn_multistep_burnin(
            st["theta"], st["v"], st["tau"], st["g"], st["v_hat"], x_win,
            y_win, 0.01, 1, h=114)
        torch.cuda.synchronize()
        assert fs.placements == {("fused_bnn_multistep_burnin", "device"): 1}
        assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.cuda
def test_fused_bnn_wide_trains_on_the_card(cuda_device):
    """units=(100,) * 3 with SGHMC on the fused path, which JAX's fused
    path takes: burn-in and sampling run on the device-memory placement."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    fs.placements.clear()
    bnn = BayesianNeuralNetwork(network="dense", step_impl="fused",
                                units=(100,) * 3, n_chains=64, n_nets=128,
                                burn_in_steps=300, sample_steps=50,
                                n_iters=400, log_every=None)
    bnn.train(x, np.sinc(x[:, 0] * 10 - 5))
    assert fs.placements == {
        ("fused_bnn_multistep_burnin_clt", "device"): 1,
        ("fused_bnn_multistep_clt", "device"): 2}
    assert set(fs.placements) == {
        ("fused_bnn_multistep_burnin_clt", "device"),
        ("fused_bnn_multistep_clt", "device")}
    mean, var = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])
    assert np.isfinite(mean).all() and np.isfinite(var).all()


def _bf16_check(label, ref, args, common, got, want, ulps, peaks=None):
    """``chip_smoke.py``'s bf16 check of a kernel's outputs against its
    plain version's: REL_TOL of each row's largest |value| plus ``ulps``
    bf16 ulps of each bf16 value (of its largest |value| over the steps
    where ``peaks`` gives it; for the other outputs, of the row's largest
    bf16 value, at most of their own), and the share of bf16 values that
    differ beside the witness, the plain version on the CPU against the one
    on the card."""
    cpu = ref(*[a.cpu() if torch.is_tensor(a) else a for a in args],
              **common)
    flips, total = cs._bf16_flips(torch, [w.cpu() for w in want],
                                  cpu if isinstance(cpu, tuple) else (cpu,))
    cs._compare(torch, (label, [str(i) for i in range(len(got))]), got,
                want, ulps=ulps, witness=flips / total if total else 0.0,
                peaks=peaks)


# bf16 instantiation -> (wrapper, plain version, state names, which of them
# bf16, keywords, stepsize, one-step?)
BF16_KERNELS = {
    "B1": (fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref,
           ("theta", "v", "minv"), ("v", "minv"), dict(mdecay=0.05), 0.01,
           False),
    "B2": (fs.fused_bnn_multistep_burnin, fs.fused_bnn_multistep_burnin_ref,
           ("theta", "v", "tau", "g", "v_hat"), ("v",), dict(mdecay=0.05),
           0.01, False),
    "B3": (fs.fused_bnn_step, fs.fused_bnn_step_ref, ("theta", "v", "minv"),
           ("v", "minv"), dict(mdecay=0.05), 0.01, True),
    "B4-sgld": (fs.fused_bnn_step_sgld, fs.fused_bnn_step_sgld_ref,
                ("theta", "minv"), ("minv",), {}, 1e-3, True),
    "B5-sgld": (fs.fused_bnn_multistep_sgld, fs.fused_bnn_multistep_sgld_ref,
                ("theta", "minv"), ("minv",), {}, 1e-3, False),
    "B4-psgld": (fs.fused_bnn_step_psgld, fs.fused_bnn_step_psgld_ref,
                 ("theta", "acc"), ("acc",), {}, 1e-3, True),
    "B4-sgnht": (fs.fused_bnn_step_sgnht, fs.fused_bnn_step_sgnht_ref,
                 ("theta", "p", "xi"), ("p",), {}, 1e-3, True),
    "B4-rsghmc": (fs.fused_bnn_step_rsghmc, fs.fused_bnn_step_rsghmc_ref,
                  ("theta", "p"), ("p",), {}, 1e-3, True),
    "B5-sgnht": (fs.fused_bnn_multistep_sgnht,
                 fs.fused_bnn_multistep_sgnht_ref, ("theta", "p", "xi"),
                 ("p",), {}, 1e-3, False),
    "B5-rsghmc": (fs.fused_bnn_multistep_rsghmc,
                  fs.fused_bnn_multistep_rsghmc_ref, ("theta", "p"), ("p",),
                  {}, 1e-3, False),
}


def _bf16_state(kernel, device, n):
    """The bf16 test's operands of ``kernel`` and its keywords: the state a
    200-step SGHMC burn-in leaves, bf16 where the kernel takes it."""
    gen = torch.Generator(device=device).manual_seed(1)
    x, y = _data(gen)
    _, _, names, bf16, kw, eps, _ = BF16_KERNELS[kernel]
    lay, st = _burned_in(SGHMCSampler, x, y, n)
    st["acc"] = st["v_hat"] * 1e-3
    st["p"] = torch.randn(st["theta"].shape, generator=gen, device=device)
    st["xi"] = 1.0 + 0.1 * torch.randn(n, generator=gen, device=device)
    state = [st[name].to(torch.bfloat16) if name in bf16 else st[name]
             for name in names]
    common = dict(prior_scale=1.0 / (lay.n_params * 100), **kw)
    if kernel[3:] != "rsghmc":
        common["scale_grad"] = 100.0
    if any(name in ("v", "acc", "p") for name in bf16):
        common["state_dtype"] = torch.bfloat16
    return state, fs.data_windows(x, y, 20), eps, common


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(BF16_KERNELS))
def test_bf16_kernel_matches_plain_version(kernel, cuda_device):
    """Each bf16-state instantiation against its plain version on the
    Philox stream, 3 steps from the burned-in state."""
    n, k = 64, 3
    fn, ref, _, _, _, _, one_step = BF16_KERNELS[kernel]
    state, (x_win, y_win), eps, common = _bf16_state(kernel, cuda_device, n)
    if one_step:
        steps = 1
        widx = fs.philox_windows(9, 77, n, x_win.shape[0], cuda_device)
        args = state + [*fs.gather_batch(x_win, y_win, widx), eps, 9]
        common["step"] = 77
    else:
        steps = k
        args = state + [x_win, y_win, eps, 9]
        common.update(k_steps=k, step0=77)
    before = fn.launches
    got = fn(*args, **common)
    assert fn.launches == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    _bf16_check(kernel, ref, args, common, got, want, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_impl", ["box_muller", "hadamard_clt"])
def test_sgnht_thermostat_of_k_steps_equals_k_single_steps(noise_impl,
                                                           cuda_device):
    """B5-sgnht at f32 state: one launch of k steps equals k launches of
    one step, bit for bit, xi included (each step's thermostat is formed
    from the partial sums of p'^T p' that the step before it left)."""
    n, k = 64, 4
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, y = _data(gen)
    fn, _, rule, eps = FUSED_NEW["B5-sgnht"]
    lay, st = _burned_in(SGHMCSampler, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    state = [st["theta"],
             torch.randn(st["theta"].shape, generator=gen,
                         device=cuda_device),
             1.0 + 0.1 * torch.randn(n, generator=gen, device=cuda_device)]
    common = dict(prior_scale=1.0 / (lay.n_params * 100),
                  noise_impl=noise_impl, **rule)
    whole = fn(*state, x_win, y_win, eps, 11, k_steps=k, step0=30, **common)
    carried = state
    for t in range(k):
        out = fn(*carried, x_win, y_win, eps, 11, k_steps=1, step0=30 + t,
                 **common)
        carried = list(out[:-1])
    torch.cuda.synchronize()
    assert len(whole) == len(out) == 4
    for a, b in zip(whole, out):
        assert torch.equal(a, b)
    assert not torch.equal(whole[2], state[2])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2", "B5-sgld", "B5-sgnht",
                                    "B5-rsghmc"])
def test_bf16_chunked_launches_equal_one_launch(kernel, cuda_device):
    """Under bf16 state two launches of k steps equal one launch of 2k on
    the card, bit for bit: the kernel rounds the momentum after every step,
    not once per launch."""
    n, k = 64, 2
    fn = BF16_KERNELS[kernel][0]
    state, (x_win, y_win), eps, common = _bf16_state(kernel, cuda_device, n)
    whole = fn(*state, x_win, y_win, eps, 9, k_steps=2 * k, step0=77,
               **common)
    first = fn(*state, x_win, y_win, eps, 9, k_steps=k, step0=77, **common)
    carried = min(len(first) - 1, len(state))  # the state the kernel moves
    second = fn(*first[:carried], *state[carried:], x_win, y_win, eps, 9,
                k_steps=k, step0=77 + k, **common)
    torch.cuda.synchronize()
    assert len(whole) == len(second)
    for a, b in zip(whole, second):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if "state_dtype" in common:
        assert whole[1].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(SLIM) + sorted(SLIM_B8))
def test_bf16_slim_kernel_matches_plain_version(kernel, cuda_device):
    """Each slim kernel with bf16 v, minv and gradient (the lanes path under
    compute_dtype and bf16 state) against its plain version on the Philox
    stream: one step, one bf16 ulp on top of REL_TOL; v' stays bf16."""
    n = 64
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, y = _data(gen)
    lay, st = _burned_in(SGHMCSampler, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    widx = fs.philox_windows(3, 0, n, x_win.shape[0], cuda_device)
    st["grad"] = fs._fwd_bwd(st["theta"], lay, x_win[widx][:, :, None],
                             y_win[widx], 1.0 / 20, 1.0 / 100)[1]
    prior = 1.0 / (lay.n_params * 100)
    if kernel in SLIM:
        fn, ref, _, names, eps = SLIM[kernel]
        common = dict(scale_grad=100.0, prior_scale=prior)
        args = [st[name] for name in names] + [None]
    else:
        fn, ref, rule = SLIM_B8[kernel]
        eps, common = 1e-3, dict(prior_scale=prior, **rule)
        aux = (st["grad"] * st["grad"] if kernel == "B8-psgld"
               else torch.randn(st["theta"].shape, generator=gen,
                                device=cuda_device))
        args = [st["theta"], aux, st["grad"], None]
        if kernel == "B8-sgnht":
            args.append(1.0 + 0.1 * torch.randn(n, generator=gen,
                                                device=cuda_device))
    names = SLIM[kernel][3] if kernel in SLIM else ("theta", "v", "grad")
    args = [a.to(torch.bfloat16) if name in ("v", "minv", "grad") else a
            for name, a in zip(names, args)] + args[len(names):]
    before = fn.launches
    got = fn(*args, eps, 2**63 + 5, step=2**32 - 1, **common)
    assert fn.launches == before + 1
    want = ref(*args, eps, 2**63 + 5, step=2**32 - 1, **common)
    torch.cuda.synchronize()
    got, want = (out if isinstance(out, tuple) else (out,)
                 for out in (got, want))
    assert len(got) == len(want)
    _bf16_check(kernel, ref, [*args, eps, 2**63 + 5],
                dict(step=2**32 - 1, **common), got, want, 1)


# the kernels held at hidden width 100, depth 3, on the device-memory
# placement: (wrapper, plain version, state names, keywords, stepsize)
WIDE = {
    "B1": KERNELS["B1"], "B2": KERNELS["B2"], "B5-sgld": KERNELS["B5-sgld"],
    "B6": KERNELS["B6"],
}
WIDE_IDS = {"B1": fs.B1, "B2": fs.B2, "B5-sgld": fs.B5_SGLD, "B6": fs.B6}


def _placed(kernel, lay):
    """The placements the launches since ``fs.placements.clear()`` took,
    against the one the library's count gives (at H = 100 device memory,
    but B6's: its EMAs live in the output arrays, and its theta and
    gradient fit shared memory)."""
    return ({where for _, where in fs.placements},
            {fs.fused_placement(WIDE_IDS[kernel], lay, 20)})


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(WIDE))
def test_wide_kernel_matches_plain_version(kernel, cuda_device):
    """H = 100, depth 3 (P = 20,502): the state lives in device memory
    (B6's theta and gradient in shared memory); the kernel against its
    plain version over 4 steps on the Philox stream, from the uniform test
    state (minv in [0.2, 1.2])."""
    n, k = 32, 4
    fn, ref, _, names, eps = WIDE[kernel]
    lay, st, x_win, y_win, _ = _state(cuda_device, n, h=100, depth=3)
    assert fs.fused_placement(WIDE_IDS[kernel], lay, 20) == (
        "shared" if kernel == "B6" else "device")
    args = [st[name] for name in names] + [x_win, y_win, eps, 2**40 + 1]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  h=100, k_steps=k, step0=5)
    fs.placements.clear()
    got = fn(*args, **common)
    want = ref(*args, **common)
    torch.cuda.synchronize()
    assert sum(fs.placements.values()) == 1
    taken, counted = _placed(kernel, lay)
    assert taken == counted
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B2", "B6"])
@pytest.mark.parametrize("h,depth", [(13, 2), (13, 3), (50, 2), (50, 3)])
@pytest.mark.parametrize("stream", ["philox", "clt"])
def test_burnin_kernel_across_widths_and_depths(kernel, h, depth, stream,
                                                cuda_device):
    """The burn-in kernels at hidden widths that cut the products' register
    tiles (13 and 50 over 2 x 2 and 3 x 4 outputs a thread) at depths 2 and
    3: against the plain version over 4 steps from the uniform test state,
    and two launches of 2 steps equal one of 4 bit for bit (the EMAs carried
    in the output arrays)."""
    n, k = 32, 4
    fn, ref, _, names, eps = KERNELS[kernel]
    lay, st, x_win, y_win, _ = _state(cuda_device, n, h=h, depth=depth)
    state = [st[name] for name in names]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  h=h)
    if stream == "clt":
        common["noise_impl"] = "hadamard_clt"
    seed = 2**40 + 1
    got = fn(*state, x_win, y_win, eps, seed, k_steps=k, step0=5, **common)
    want = ref(*state, x_win, y_win, eps, seed, k_steps=k, step0=5, **common)
    first = fn(*state, x_win, y_win, eps, seed, k_steps=k // 2, step0=5,
               **common)
    second = fn(*first[:len(names)], x_win, y_win, eps, seed, k_steps=k // 2,
                step0=5 + k // 2, **common)
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(second)
    for a, b, c in zip(got, want, second):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL
        assert torch.equal(a, c)


# the sampling kernels -> (wrapper, plain version, state names, rule
# keywords, stepsize, one-step?)
EDGE_KERNELS = {
    "B1": (fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref,
           ("theta", "v", "minv"), dict(mdecay=0.05, scale_grad=100.0), 0.01,
           False),
    "B3": (fs.fused_bnn_step, fs.fused_bnn_step_ref, ("theta", "v", "minv"),
           dict(mdecay=0.05, scale_grad=100.0), 0.01, True),
    "B5-sgld": (fs.fused_bnn_multistep_sgld, fs.fused_bnn_multistep_sgld_ref,
                ("theta", "minv"), dict(scale_grad=100.0), 1e-3, False),
    "B4-sgld": (fs.fused_bnn_step_sgld, fs.fused_bnn_step_sgld_ref,
                ("theta", "minv"), dict(scale_grad=100.0), 1e-3, True),
    "B5-psgld": (fs.fused_bnn_multistep_psgld,
                 fs.fused_bnn_multistep_psgld_ref, ("theta", "acc"),
                 dict(alpha=0.99, lambda_reg=1e-5, scale_grad=100.0), 1e-4,
                 False),
    "B4-psgld": (fs.fused_bnn_step_psgld, fs.fused_bnn_step_psgld_ref,
                 ("theta", "acc"),
                 dict(alpha=0.99, lambda_reg=1e-5, scale_grad=100.0), 1e-4,
                 True),
    "B5-sgnht": (fs.fused_bnn_multistep_sgnht,
                 fs.fused_bnn_multistep_sgnht_ref, ("theta", "p", "xi"),
                 dict(a_diff=1.0, scale_grad=100.0), 3e-4, False),
    "B4-sgnht": (fs.fused_bnn_step_sgnht, fs.fused_bnn_step_sgnht_ref,
                 ("theta", "p", "xi"), dict(a_diff=1.0, scale_grad=100.0),
                 3e-4, True),
    "B5-rsghmc": (fs.fused_bnn_multistep_rsghmc,
                  fs.fused_bnn_multistep_rsghmc_ref, ("theta", "p"),
                  dict(mass=1.0, speed_of_light=1.0, d_coef=1.0), 1e-3,
                  False),
    "B4-rsghmc": (fs.fused_bnn_step_rsghmc, fs.fused_bnn_step_rsghmc_ref,
                  ("theta", "p"),
                  dict(mass=1.0, speed_of_light=1.0, d_coef=1.0), 1e-3,
                  True),
}
# (hidden width, depth, batch): widths 13 and 50 cut the 16 x 8 output
# tiles and the 8-deep k-steps of the tensor-core products, batches 1, 7,
# 20 and 33 the 8-wide side (and the weight gradients' k-steps)
EDGE_SHAPES = [(h, depth, batch) for h, depth in ((13, 2), (13, 3), (50, 2),
                                                  (50, 3))
               for batch in (1, 7, 20, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stream,bf16", [
    (kernel, stream, bf16) for kernel in sorted(EDGE_KERNELS)
    for stream in ("philox", "clt")
    # pSGLD's accumulator is f32 (as JAX's)
    for bf16 in ((False,) if kernel.endswith("psgld") else (False, True))])
def test_sampling_kernel_across_tile_edges(kernel, stream, bf16, cuda_device):
    """The sampling kernels (B1, B5-*, and B3 / B4-* one step) at shapes
    that cut the tiles of the tensor-core products, on the Philox and CLT
    streams, against their plain versions from the uniform test state: at
    f32 state over 4 steps (one for B3 / B4-*) within REL_TOL of each
    chain's row, at bf16 state (the momentum or accumulator, and SGHMC's and
    SGLD's minv) over 3 with one bf16 ulp a step of each value's largest
    |value| over the steps (``chip_smoke._compare``), on as many values as
    the bf16 tests at the flagship's width hold (64 chains x 5,252), so
    that the share of flipped values is measured as finely."""
    fn, ref, names, rule, eps, one_step = EDGE_KERNELS[kernel]
    x, y = _data(torch.Generator(device=cuda_device).manual_seed(3))
    for h, depth, batch in EDGE_SHAPES:
        n = 32
        if bf16:
            n = -(-64 * 5252 // fs.FusedLayout(1, h, depth).n_params)
        lay, st, _, _, gen = _state(cuda_device, n, h=h, depth=depth)
        st["acc"] = st["v_hat"] * 1e-3
        st["p"] = torch.randn(st["theta"].shape, generator=gen,
                              device=cuda_device)
        st["xi"] = 1.0 + 0.1 * torch.randn(n, generator=gen,
                                           device=cuda_device)
        state = [st[name] for name in names]
        common = dict(rule, prior_scale=1.0 / (lay.n_params * 100), h=h,
                      batch_size=batch)
        if stream == "clt":
            common["noise_impl"] = "hadamard_clt"
        if bf16:
            state = [t.to(torch.bfloat16) if name in ("v", "minv", "p")
                     else t for name, t in zip(names, state)]
            if any(name in ("v", "p") for name in names):
                common["state_dtype"] = torch.bfloat16
        x_win, y_win = fs.data_windows(x, y, batch)
        if one_step:
            steps = 1
            widx = fs.philox_windows(9, 77, n, x_win.shape[0], cuda_device)
            args = state + [*fs.gather_batch(x_win, y_win, widx), eps, 9]
            common["step"] = 77
        else:
            steps = 3 if bf16 else 4
            args = state + [x_win, y_win, eps, 9]
            common.update(k_steps=steps, step0=5)
        got = fn(*args, **common)
        want = ref(*args, **common)
        torch.cuda.synchronize()
        label = "{} h={} depth={} batch={}".format(kernel, h, depth, batch)
        assert len(got) == len(want), label
        if bf16:
            # a value's rounding flips at the size it had then: its ulps
            # are those of its largest |value| over the steps (as
            # chip_smoke's bf16 checks take them)
            outs = [ref(*args, **dict(common, k_steps=k))
                    for k in range(1, steps)] + [want]
            peaks = [torch.stack([o[i].float().abs() for o in outs]).amax(0)
                     if w.dtype == torch.bfloat16 else None
                     for i, w in enumerate(want)]
            _bf16_check(label, ref, args, common, got, want, steps, peaks)
            continue
        for a, b in zip(got, want):
            assert torch.isfinite(a).all(), label
            assert _row_rel_err(a.reshape(len(a), -1),
                                b.reshape(len(b), -1)) <= REL_TOL, label


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,bf16", [("B2", False), ("B2", True),
                                         ("B6", False)])
def test_wide_burnin_chunked_launches_equal_one_launch(kernel, bf16,
                                                       cuda_device):
    """H = 100 (the state in device memory, the EMAs in the output
    arrays): two launches of k steps equal one of 2k bit for bit, at f32
    and bf16 state; at bf16 state the kernel is also held against its
    plain version (one bf16 ulp a step)."""
    n, k = 16, 2
    fn, ref, _, names, eps = WIDE[kernel]
    lay, st, x_win, y_win, _ = _state(cuda_device, n, h=100, depth=3)
    state = [st[name] for name in names]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  h=100)
    if bf16:
        state[1] = state[1].to(torch.bfloat16)
        common["state_dtype"] = torch.bfloat16
    seed = 2**40 + 1
    fs.placements.clear()
    whole = fn(*state, x_win, y_win, eps, seed, k_steps=2 * k, step0=5,
               **common)
    first = fn(*state, x_win, y_win, eps, seed, k_steps=k, step0=5, **common)
    second = fn(*first[:len(names)], x_win, y_win, eps, seed, k_steps=k,
                step0=5 + k, **common)
    torch.cuda.synchronize()
    taken, counted = _placed(kernel, lay)
    assert taken == counted
    for a, b in zip(whole, second):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if bf16:
        assert whole[1].dtype == torch.bfloat16
        args = state + [x_win, y_win, eps, seed]
        kw = dict(common, k_steps=2 * k, step0=5)
        _bf16_check(kernel + " H=100", ref, args, kw, whole, ref(*args, **kw),
                    2 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["philox", "clt"])
def test_sgld_burnin_kernel_in_device_memory(stream, cuda_device):
    """B6 with its theta and gradient in device memory (H = 114, depth 3:
    P = 26,564): against its plain version over 4 steps, and two launches
    of 2 steps equal one of 4 bit for bit."""
    n, k = 16, 4
    fn, ref, _, names, eps = WIDE["B6"]
    lay, st, x_win, y_win, _ = _state(cuda_device, n, h=114, depth=3)
    assert fs.fused_placement(fs.B6, lay, 20) == "device"
    state = [st[name] for name in names]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  h=114)
    if stream == "clt":
        common["noise_impl"] = "hadamard_clt"
    seed = 2**40 + 1
    fs.placements.clear()
    got = fn(*state, x_win, y_win, eps, seed, k_steps=k, step0=5, **common)
    want = ref(*state, x_win, y_win, eps, seed, k_steps=k, step0=5, **common)
    first = fn(*state, x_win, y_win, eps, seed, k_steps=k // 2, step0=5,
               **common)
    second = fn(*first[:len(names)], x_win, y_win, eps, seed, k_steps=k // 2,
                step0=5 + k // 2, **common)
    torch.cuda.synchronize()
    assert {where for _, where in fs.placements} == {"device"}
    for a, b, c in zip(got, want, second):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(BF16_KERNELS))
def test_clt_bf16_kernel_matches_plain_version(kernel, cuda_device):
    """Each CLT instantiation at bf16 state against its plain version, as
    the Box-Muller ones (3 steps, one bf16 ulp per step)."""
    n, k = 64, 3
    fn, ref, _, _, _, _, one_step = BF16_KERNELS[kernel]
    state, (x_win, y_win), eps, common = _bf16_state(kernel, cuda_device, n)
    common["noise_impl"] = "hadamard_clt"
    if one_step:
        steps = 1
        widx = fs.philox_windows(9, 77, n, x_win.shape[0], cuda_device)
        args = state + [*fs.gather_batch(x_win, y_win, widx), eps, 9]
        common["step"] = 77
    else:
        steps = k
        args = state + [x_win, y_win, eps, 9]
        common.update(k_steps=k, step0=77)
    before = fs.variant_launches(fn, "hadamard_clt")
    got = fn(*args, **common)
    assert fs.variant_launches(fn, "hadamard_clt") == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    _bf16_check(kernel + " clt", ref, args, common, got, want, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(WIDE))
def test_clt_wide_kernel_matches_plain_version(kernel, cuda_device):
    """The CLT instantiations at H = 100 (state in device memory; the
    generator's 256-lane groups)."""
    n, k = 32, 4
    fn, ref, _, names, eps = WIDE[kernel]
    lay, st, x_win, y_win, _ = _state(cuda_device, n, h=100, depth=3)
    args = [st[name] for name in names] + [x_win, y_win, eps, 2**40 + 1]
    common = dict(scale_grad=100.0, prior_scale=1.0 / (lay.n_params * 100),
                  h=100, k_steps=k, step0=5, noise_impl="hadamard_clt")
    fs.placements.clear()
    got = fn(*args, **common)
    want = ref(*args, **common)
    torch.cuda.synchronize()
    taken, counted = _placed(kernel, lay)
    assert taken == counted
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a, b) <= REL_TOL


@pytest.mark.cuda
def test_clt_knob_reaches_the_kernel(cuda_device):
    """A CLT and a Box-Muller launch from one state differ; each equals its
    own plain version."""
    lay, st, x_win, y_win, _ = _state(cuda_device, 16)
    args = [st["theta"], st["v"], st["minv"], x_win, y_win, 0.01, 3]
    out = {impl: fs.fused_bnn_multistep(*args, k_steps=2, noise_impl=impl)
           for impl in fs.NOISE_IMPLS}
    assert not torch.equal(out["box_muller"][0], out["hadamard_clt"][0])
    for impl, got in out.items():
        want = fs.fused_bnn_multistep_ref(*args, k_steps=2, noise_impl=impl)
        assert _row_rel_err(got[0], want[0]) <= REL_TOL, impl


# paired instantiation -> its BF16_KERNELS entry (B5-psgld from B1's state,
# its accumulator f32) and whether it has a bf16 state
PAIRED = {"B1": "B1", "B2": "B2", "B3": "B3", "B5-sgld": "B5-sgld",
          "B5-sgnht": "B5-sgnht", "B5-rsghmc": "B5-rsghmc", "B6": "B6",
          "B5-psgld": "B5-psgld"}


def _paired_args(kernel, device, n, bf16):
    """The paired test's wrapper, plain version, arguments and keywords:
    the bf16 test's state (float32 unless ``bf16``), 3 steps from step 77
    (one for B3)."""
    if kernel in ("B6", "B5-psgld"):
        fn, ref = {"B6": (fs.fused_bnn_multistep_burnin_sgld,
                          fs.fused_bnn_multistep_burnin_sgld_ref),
                   "B5-psgld": (fs.fused_bnn_multistep_psgld,
                                fs.fused_bnn_multistep_psgld_ref)}[kernel]
        state, (x_win, y_win), eps, common = _bf16_state("B2", device, n)
        theta, tau, g, v_hat = state[0], *state[2:]
        state = ([theta, tau, g, v_hat] if kernel == "B6"
                 else [theta, v_hat * 1e-3])
        common = dict(prior_scale=common["prior_scale"], scale_grad=100.0)
        eps, one_step = 1e-3, False
    else:
        fn, ref, _, _, _, _, one_step = BF16_KERNELS[kernel]
        state, (x_win, y_win), eps, common = _bf16_state(kernel, device, n)
        if not bf16:
            state = [t.float() for t in state]
            common.pop("state_dtype", None)
    common["pair_dots"] = True
    if one_step:
        widx = fs.philox_windows(9, 77, n, x_win.shape[0], device)
        args = state + [*fs.gather_batch(x_win, y_win, widx), eps, 9]
        common["step"] = 77
    else:
        args = state + [x_win, y_win, eps, 9]
        common.update(k_steps=3, step0=77)
    return fn, ref, args, common, 1 if one_step else 3


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(PAIRED))
@pytest.mark.parametrize("bf16", [False, True])
def test_paired_kernel_matches_plain_version(kernel, bf16, cuda_device):
    n = 64
    fn, ref, args, common, steps = _paired_args(kernel, cuda_device, n, bf16)
    before = fs.variant_launches(fn, "paired")
    got = fn(*args, **common)
    assert fs.variant_launches(fn, "paired") == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    if any(t.dtype == torch.bfloat16 for t in got):
        _bf16_check(kernel + " paired", ref, args, common, got, want, steps)
        return
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a.reshape(len(a), -1),
                            b.reshape(len(b), -1)) <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(PAIRED))
def test_paired_kernel_equals_unpaired_at_f32(kernel, cuda_device):
    """At f32 state each paired kernel gives its unpaired kernel's outputs
    bit for bit (the same normals, windows and arithmetic) over 16 steps
    at 8192 chains (one step for B3)."""
    fn, _, args, common, _ = _paired_args(kernel, cuda_device, 8192, False)
    if "k_steps" in common:
        common["k_steps"] = 16
    paired = fn(*args, **common)
    unpaired = fn(*args, **dict(common, pair_dots=False))
    torch.cuda.synchronize()
    for a, b in zip(paired, unpaired):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_paired_bnn_trains_on_the_card(cuda_device):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    fs.placements.clear()
    bnn = BayesianNeuralNetwork(
        network="dense", step_impl="fused", pair_dots=True, n_chains=256,
        n_nets=512, burn_in_steps=1500, sample_steps=50, n_iters=1600,
        compute_dtype=torch.bfloat16)
    bnn.train(x, y)
    # log_every = 512 cuts the burn-in into 512 + 512 + 476 steps
    assert fs.variant_launches(fs.fused_bnn_multistep_burnin, "paired") == 3
    assert fs.variant_launches(fs.fused_bnn_multistep, "paired") == 2
    mean, var = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    truth = np.sinc(np.linspace(0.0, 1.0, 50) * 10 - 5)
    assert np.mean((mean - truth) ** 2) < 0.1


def _svgd_inputs(device, n, d, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 0.3 * torch.randn((n, d), generator=gen, device=device)
    g = torch.randn((n, d), generator=gen, device=device)
    return x, g, pairwise.median_bandwidth(
        pairwise.squared_distance_matrix(x), n)


def _check_svgd(x, g, h):
    """B11 against its plain version, per particle row: within REL_TOL of
    the row's largest |phi|; two launches agree bit for bit."""
    n, d = x.shape
    ss.svgd_phi_streaming.launches = 0
    got = ss.svgd_phi_streaming(x, g, h)
    again = ss.svgd_phi_streaming(x, g, h)
    want = ss.svgd_phi_streaming_ref(x, g, h)
    torch.cuda.synchronize()
    assert ss.svgd_phi_streaming.launches == 2
    assert got.shape == (n, d) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = (got - want).abs().amax(1) / want.abs().amax(1)
    assert float(err.max()) <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", list(cs.SVGD_SHAPES) + [(4096, 5252)])
def test_svgd_kernel_matches_plain_version(n, d, cuda_device):
    """B11 on the JAX package's streaming shapes and the flagship's."""
    _check_svgd(*_svgd_inputs(cuda_device, n, d))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(2, 3), (70, 5), (65, 9), (300, 20),
                                 (257, 68), (257, 1321), (513, 4100)])
def test_svgd_kernel_on_shapes_that_cut_its_tiles(n, d, cuda_device):
    """B11's row tiles (64 particles), column tiles (256), the feature
    halves of a cluster of 2 (d / 2 rounded up to 4: the second block owns
    none of 3 features, one of 5 or 9, and 32 of 68, where the first
    block's 36 cut a 32-deep stage), its 32-deep stages and its 16-byte
    copies (d a multiple of 4) cut off their edges: n not a multiple of 64
    or 256, d not a multiple of 8 or 32, with 4-byte copies (3, 5, 9,
    1321) and 16-byte ones (20, 68, 4100)."""
    _check_svgd(*_svgd_inputs(cuda_device, n, d))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (1, 6), (3, 1)])
def test_svgd_kernel_at_one_particle_or_one_feature(n, d, cuda_device):
    """B11 where the cluster's second block owns no feature (d = 1)
    and where one particle is its own only neighbour (h = 1: the median
    bandwidth of one particle is 0)."""
    x, g, h = _svgd_inputs(cuda_device, n, d)
    _check_svgd(x, g, 1.0 if n == 1 else h)


@pytest.mark.cuda
def test_svgd_kernel_refuses_interpret_and_takes_a_float_h(cuda_device):
    x, g, h = _svgd_inputs(cuda_device, 64, 7)
    with pytest.raises(ValueError, match="interpret"):
        ss.svgd_phi_streaming(x, g, h, interpret=True)
    assert torch.equal(ss.svgd_phi_streaming(x, g, float(h)),
                       ss.svgd_phi_streaming(x, g, h))


@pytest.mark.cuda
def test_svgd_bnn_trains_on_the_card(cuda_device):
    """The SVGD slice on the card: B11 once a step, the samples and the
    ensemble's predictions on the card, the sinc gate, spread members."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    ss.svgd_phi_streaming.launches = 0
    bnn = BayesianNeuralNetwork(sampling_method=Sampler.SVGD,
                                kernel_impl="streaming", n_nets=64,
                                n_iters=300)  # on the card by default
    bnn.train(x, y)
    assert ss.svgd_phi_streaming.launches == 300
    assert bnn.samples["w1"].is_cuda and bnn.samples["w1"].shape == (64, 1,
                                                                       50)
    grid = np.linspace(0.0, 1.0, 50)[:, None]
    mean, var = bnn.predict(grid)
    f_out, _ = bnn.predict(grid, return_individual_predictions=True)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert np.mean((mean - np.sinc(grid[:, 0] * 10 - 5)) ** 2) < 0.1
    assert np.std(f_out, axis=0).mean() > 1e-6


#  B10, B7 mask, B7': FusedSGHMC and the packed and stacked drivers ----------

def _sghmc_check_state(device, n=64):
    """The burned-in SGHMC state with the gradient of one step's windows,
    ``(lay, st)``; the leaves as a dict in ``st["tree"]``."""
    gen = torch.Generator(device=device).manual_seed(0)
    x, y = _data(gen)
    lay, st = _burned_in(SGHMCSampler, x, y, n)
    x_win, y_win = fs.data_windows(x, y, 20)
    widx = fs.philox_windows(3, 0, n, x_win.shape[0], device)
    st["grad"] = fs._fwd_bwd(st["theta"], lay, x_win[widx][:, :, None],
                             y_win[widx], 1.0 / 20, 1.0 / 100)[1]
    return lay, st, gen


@pytest.mark.cuda
@pytest.mark.parametrize("burning_in", [True, False])
@pytest.mark.parametrize("stream", ["injected", "philox"])
def test_fused_update_matches_plain_version(burning_in, stream, cuda_device):
    """B10 on the burned-in state padded to 128 columns (as FusedSGHMC
    pads it), in both phases."""
    lay, st, gen = _sghmc_check_state(cuda_device)
    pad = fu.pad_dim(lay.n_params) - lay.n_params

    def padded(t, value=0.0):
        return torch.nn.functional.pad(t, (0, pad), value=value)

    args = [padded(st["theta"]), padded(st["v"])] + [
        padded(st[k], 1.0) for k in ("tau", "g", "v_hat", "minv")] + [
        padded(st["grad"])]
    extra = {"step": 2**32 - 1}
    if stream == "injected":
        extra = {"noise": torch.randn(args[0].shape, generator=gen,
                                      device=cuda_device)}
    kw = dict(mdecay=0.05, scale_grad=100.0, **extra)
    before = fu.fused_sghmc_update.launches
    got = fu.fused_sghmc_update(*args, 0.01, burning_in, 2**63 + 5, **kw)
    assert fu.fused_sghmc_update.launches == before + 1
    want = fu.fused_sghmc_update_ref(*args, 0.01, burning_in, 2**63 + 5,
                                     **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _row_rel_err(a[:, :lay.n_params],
                            b[:, :lay.n_params]) <= REL_TOL
    if not burning_in:
        assert torch.equal(got[5], args[5])


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stream", ["injected", "philox"])
def test_masked_kernel_matches_plain_version(grad_dtype, stream,
                                             cuda_device):
    """B7 mask on the packed slab of the dense network's leaves (noise
    non-zero on the padding where injected); the padding of theta' and v'
    stays exactly 0."""
    lay, st, gen = _sghmc_check_state(cuda_device)
    tree = {k: fs.unpack(st[k], lay) for k in ("theta", "v", "grad", "minv")}
    spec = make_pack_spec({k: leaf[0] for k, leaf in tree["theta"].items()})
    args = [pack_tree(spec, tree[k]) for k in ("theta", "v", "grad", "minv")]
    args[2] = args[2].to(grad_dtype)
    mask = pack_mask(spec, device=cuda_device)
    extra = {"step": 2**32 - 1, "noise_index": torch.randperm(
        spec.width, generator=gen, device=cuda_device).to(torch.int32)}
    if stream == "injected":
        extra = {"noise": torch.randn(args[0].shape, generator=gen,
                                      device=cuda_device)}
    kw = dict(mdecay=0.05, scale_grad=100.0,
              prior_scale=1.0 / (lay.n_params * 100), **extra)
    before = su.slim_sghmc_update.launches
    got = su.slim_sghmc_update(*args, mask, 0.01, 2**63 + 5, **kw)
    assert su.slim_sghmc_update.launches == before + 1
    want = su.slim_sghmc_update_ref(*args, mask, 0.01, 2**63 + 5, **kw)
    torch.cuda.synchronize()
    padding = mask[0] == 0
    for a, b in zip(got, want):
        assert _row_rel_err(a, b) <= REL_TOL
        assert not a[:, padding].any()


def _many_leaves(device, n, n_leaves, gen):
    """A stacked tree of ``n_leaves`` leaves of assorted shapes."""
    shapes = [(3,), (7, 5), (), (1, 300), (2, 2, 2)]
    theta = {"leaf{:02d}".format(i): torch.randn(
        (n,) + shapes[i % len(shapes)], generator=gen, device=device)
        for i in range(n_leaves)}

    def like(scale=1.0, positive=False):
        out = {k: scale * torch.randn(t.shape, generator=gen, device=device)
               for k, t in theta.items()}
        return {k: t.abs() + 0.1 for k, t in out.items()} if positive \
            else out

    return theta, like(1e-2), like(), like(positive=True)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_bf16", [False, True])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stream", ["injected", "philox"])
def test_tree_kernel_matches_plain_version(emit_bf16, grad_dtype, stream,
                                           cuda_device):
    """B7' on the dense network's leaves; the bf16 copy is the kernel's
    theta' rounded, exactly."""
    lay, st, gen = _sghmc_check_state(cuda_device)
    tree = {k: {name: leaf.contiguous() for name, leaf in
                fs.unpack(st[k], lay).items()}
            for k in ("theta", "v", "grad", "minv")}
    tree["grad"] = {k: g.to(grad_dtype) for k, g in tree["grad"].items()}
    extra = {"step": 2**32 - 1}
    if stream == "injected":
        extra = {"noise": {k: torch.randn(t.shape, generator=gen,
                                          device=cuda_device)
                           for k, t in tree["theta"].items()}}
    kw = dict(mdecay=0.05, scale_grad=100.0, emit_bf16=emit_bf16,
              prior_scale=1.0 / (lay.n_params * 100), **extra)
    args = [tree[k] for k in ("theta", "v", "grad", "minv")]
    before = su.slim_sghmc_update_tree.launches
    got = su.slim_sghmc_update_tree(*args, 0.01, 2**63 + 5, **kw)
    assert su.slim_sghmc_update_tree.launches == before + 1
    want = su.slim_sghmc_update_tree_ref(*args, 0.01, 2**63 + 5, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (3 if emit_bf16 else 2)
    spec = make_pack_spec({k: t[0] for k, t in tree["theta"].items()})
    for a, b in zip(got[:2], want[:2]):
        assert list(a) == list(tree["theta"])
        assert _row_rel_err(pack_tree(spec, a), pack_tree(spec, b)) \
            <= REL_TOL
    if emit_bf16:
        for key, leaf in got[2].items():
            assert torch.equal(leaf, got[0][key].to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [1, 9, 40])
def test_tree_kernel_launches_once_whatever_the_leaf_count(n_leaves,
                                                           cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(n_leaves)
    args = _many_leaves(cuda_device, 33, n_leaves, gen)
    before = su.slim_sghmc_update_tree.launches
    got = su.slim_sghmc_update_tree(*args, 0.01, 7, step=3)
    assert su.slim_sghmc_update_tree.launches == before + 1
    want = su.slim_sghmc_update_tree_ref(*args, 0.01, 7, step=3)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        for key in args[0]:
            err = (a[key] - b[key]).abs().max()
            assert float(err) <= REL_TOL * float(b[key].abs().max()), key


@pytest.mark.cuda
def test_packed_stacked_and_lanes_drivers_agree_on_the_card(cuda_device):
    """From one burned-in state and generator seed, the packed (B7 mask),
    stacked (B7') and lanes (B7) drivers on the card, f32 passes, 2 samples
    of 4 steps: each launches its kernel once a step and they agree."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, y = _data(gen)
    _, apply = dense_network(1, device=cuda_device)
    bnn = BayesianNeuralNetwork(batch_size=20, step_impl="lanes")
    from pysgmcmc_tpu_torch.data_batches import batch_fn

    def cost(params, batch):
        return bnn.negative_log_likelihood(apply, params, *batch, 100)[0]

    sampler = SGHMCSampler(cost, stepsize_schedule=0.01, scale_grad=100.0)
    init, _ = dense_network(1, device=cuda_device)
    states = sampler.init(init(gen, (64,)))
    select = batch_fn(x, y, 20)
    runs = {}
    for name, fn, kernel, kw in (
            ("lanes", sample_chain_lanes, su.slim_sghmc_update,
             dict(compute_dtype=None)),
            ("packed", sample_chain_packed, su.slim_sghmc_update,
             dict(compute_dtype=None)),
            ("stacked", sample_chain_stacked, su.slim_sghmc_update_tree, {})):
        before = kernel.launches
        runs[name] = fn(sampler, states,
                        torch.Generator(device=cuda_device).manual_seed(5),
                        2, batch_fn=select, keep_every=4, **kw)
        assert kernel.launches == before + 8, name
    torch.cuda.synchronize()
    for name in ("packed", "stacked"):
        for key, want in runs["lanes"][1].items():
            got = runs[name][1][key]
            err = (got - want).abs().max()
            assert float(err) <= REL_TOL * float(want.abs().max()), (name,
                                                                      key)


@pytest.mark.cuda
def test_fused_sghmc_card_matches_cpu(cuda_device):
    """FusedSGHMC on the card (B10 each step) against the same run on the
    CPU (its plain version), on the degenerate stream, across the burn-in
    boundary."""
    def cost(params):
        return 0.5 * torch.sum(params["x"] ** 2) + torch.sum(
            params["w"] ** 2)

    template = {"x": torch.zeros(3), "w": torch.zeros(2, 2)}
    runs = {}
    for device in ("cpu", cuda_device):
        fused = FusedSGHMC(cost, template, stepsize=0.05, burn_in_steps=10,
                           noise_impl="zero")
        gen = torch.Generator().manual_seed(0)
        start = {"x": torch.randn(16, 3, generator=gen),
                 "w": torch.randn(16, 2, 2, generator=gen)}
        before = fu.fused_sghmc_update.launches
        runs[str(device)] = fused.run(
            fused.init({k: v.to(device) for k, v in start.items()}),
            torch.Generator().manual_seed(1), 20)[0]
    assert fu.fused_sghmc_update.launches == before + 20
    got, want = runs[str(cuda_device)], runs["cpu"]
    for field in ("theta", "momentum", "minv"):
        assert _row_rel_err(getattr(got, field)[:, :7].cpu(),
                            getattr(want, field)[:, :7]) <= REL_TOL, field
