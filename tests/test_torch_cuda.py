"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same inputs,
under injected noise and windows and under the Philox stream, with the
tolerance ``chip_smoke.py`` uses: 2e-4 of each output's scale (summation
order and libm ulps, carried through the steps).
"""

import numpy as np
import pytest
import torch

from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, dense_network
from pysgmcmc_tpu_torch.ops import fused_step as fs

REL_TOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


def _state(device, n, h=50, depth=3, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    init, _ = dense_network(1, units=(h,) * depth, device=device)
    lay = fs.FusedLayout(1, h, depth)
    theta = fs.pack(init(gen, (n,)), lay)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(theta.shape, generator=gen,
                                           device=device)

    x = torch.rand((100, 1), generator=gen, device=device)
    x_win, y_win = fs.data_windows(x, torch.sinc(10 * x[:, 0] - 5), 20)
    state = {"theta": theta, "v": uniform(-1e-3, 1e-3),
             "tau": uniform(1.0, 5.0), "g": uniform(-1.0, 1.0),
             "v_hat": uniform(1.0, 5.0), "minv": uniform(0.2, 1.2)}
    return lay, state, x_win, y_win, gen


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2"])
@pytest.mark.parametrize("stream", ["injected", "philox"])
def test_kernel_matches_plain_version(kernel, stream, cuda_device):
    n, k = 64, 8
    lay, st, x_win, y_win, gen = _state(cuda_device, n)
    if kernel == "B2":
        fn, ref = fs.fused_bnn_multistep_burnin, fs.fused_bnn_multistep_burnin_ref
        names = ("theta", "v", "tau", "g", "v_hat")
    else:
        fn, ref = fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref
        names = ("theta", "v", "minv")
    extra = dict(step0=2**32 - 3)  # the step counter wraps inside the launch
    if stream == "injected":
        extra = dict(
            noise=torch.randn((k, n, lay.n_params), generator=gen,
                              device=cuda_device),
            widx=torch.randint(0, x_win.shape[0], (k, n), generator=gen,
                               device=cuda_device, dtype=torch.int32))
    args = [st[name] for name in names] + [x_win, y_win, 0.01, 2**63 + 5]
    common = dict(k_steps=k, scale_grad=100.0,
                  prior_scale=1.0 / (lay.n_params * 100), **extra)
    before = fn.launches
    got = fn(*args, **common)
    assert fn.launches == before + 1
    want = ref(*args, **common)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= REL_TOL * float(b.abs().max())


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
    lay4, st4, x4, y4, _ = _state(cuda_device, 2, h=114, depth=4)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        fs.fused_bnn_multistep_burnin(
            st4["theta"], st4["v"], st4["tau"], st4["g"], st4["v_hat"], x4,
            y4, 0.01, 1, h=114)


@pytest.mark.cuda
def test_bnn_trains_on_the_card(cuda_device):
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    fs.fused_bnn_multistep.launches = 0
    fs.fused_bnn_multistep_burnin.launches = 0
    bnn = BayesianNeuralNetwork(
        network="dense", step_impl="fused", n_chains=256, n_nets=512,
        burn_in_steps=1500, sample_steps=50, n_iters=1600, device="cuda")
    bnn.train(x, y)
    assert fs.fused_bnn_multistep_burnin.launches == 3  # log_every = 512
    assert fs.fused_bnn_multistep.launches == 2
    assert bnn.samples["w2"].is_cuda and bnn.samples["w2"].shape[0] == 512
    mean, var = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    truth = np.sinc(np.linspace(0.0, 1.0, 50) * 10 - 5)
    assert np.mean((mean - truth) ** 2) < 0.1
