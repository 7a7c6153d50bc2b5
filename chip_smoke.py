#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pysgmcmc_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card (flagship shapes,
injected noise and the Philox stream), times both at the main path's shape,
then trains and predicts the flagship BNN (3x50 tanh, 8192 chains, sinc
data) through ``pysgmcmc_tpu_torch.models.BayesianNeuralNetwork`` and
checks the result.  The second-to-last line is the kernels' JSON record,
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device, or without the package beside this
script, it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_DATA, BATCH, H = 100, 20, 50
CHECK_CHAINS, CHECK_STEPS = 256, 16
MAIN_CHAINS, BURN_IN, SAMPLE_STEPS = 8192, 3000, 200
# kernel vs plain version, per output: |kernel - plain| <= REL_TOL * max|plain|.
# The two sum the 20x50 dot products in different orders (sequential f32
# loops vs cuBLAS bmm) and use different libm builds (tanhf/logf/cosf within
# 2 ulp); 16 steps carry these rounding differences, which stay near 1e-6 of
# each tensor's scale, so 2e-4 flags real disagreement only.
REL_TOL = 2e-4
# the main path at a small size, run on the card and on the CPU
SMALL = dict(network="dense", step_impl="fused", n_chains=4, n_nets=8,
             burn_in_steps=64, sample_steps=16, n_iters=96, log_every=None)


def _import_port():
    """Import the package of this checkout, and only that one."""
    sys.path.insert(0, HERE)
    import pysgmcmc_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(pysgmcmc_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise SystemExit("pysgmcmc_tpu_torch was imported from {}, not from "
                         "this checkout".format(pkg_dir))


def _data(torch, device):
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (N_DATA, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    xn = (x - x.mean(axis=0)) / x.std(axis=0)
    yn = (y - y.mean()) / y.std()
    return (x, y, torch.as_tensor(xn, dtype=torch.float32, device=device),
            torch.as_tensor(yn, dtype=torch.float32, device=device))


def _time_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _compare(torch, name, got, want):
    """Max abs error over the outputs; raises beyond REL_TOL."""
    worst = 0.0
    for label, k, p in zip(name[1], got, want):
        if not torch.isfinite(k).all():
            raise AssertionError("{}: kernel output {} is not finite".format(
                name[0], label))
        err = float((k - p).abs().max())
        scale = float(p.abs().max())
        print("  {} {}: max|kernel-plain| = {:.3e} (scale {:.3e})".format(
            name[0], label, err, scale))
        if err > REL_TOL * scale:
            raise AssertionError(
                "{}: {} disagrees with the plain version: {:.3e} > {:.1e} x "
                "{:.3e}".format(name[0], label, err, REL_TOL, scale))
        worst = max(worst, err)
    return worst


def _small_main_path(torch, x_np, y_np):
    """Train and predict a small BNN through the port's entry points twice,
    on the card (kernels) and on the CPU (plain versions), from the same
    initial weights on the degenerate stream (zero noise, window 0); returns
    the largest |card - CPU| over the samples and the predictive mean."""
    import numpy as np

    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, dense_network

    init_fn, _ = dense_network(1, units=(H, H, H), device="cpu")
    start = init_fn(torch.Generator().manual_seed(7), (SMALL["n_chains"],))
    x_grid = np.linspace(0.0, 1.0, 50)[:, None]
    runs = {}
    for device in ("cuda", "cpu"):
        bnn = BayesianNeuralNetwork(device=device, noise_impl="zero", **SMALL)
        bnn._initial_positions = (
            lambda init_fn, generator, n, d=device:
            {k: v.to(d) for k, v in start.items()})
        bnn.train(x_np, y_np)
        runs[device] = (bnn.samples, bnn.predict(x_grid)[0])
    worst = 0.0
    for key, want in runs["cpu"][0].items():
        got = runs["cuda"][0][key].cpu()
        worst = max(worst, _compare(
            torch, ("small main path", ("samples " + key,)), [got], [want]))
    mean_gpu, mean_cpu = (torch.as_tensor(runs[d][1]) for d in ("cuda", "cpu"))
    return max(worst, _compare(
        torch, ("small main path", ("predictive mean",)), [mean_gpu],
        [mean_cpu]))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, dense_network
    from pysgmcmc_tpu_torch.ops import _build, fused_step as fs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (plain versions run full f32)")
    device = torch.device("cuda")

    _, seconds = _build.build()
    _build.load()
    print("build: {} in {:.1f} s (0.0 = already built)".format(
        os.path.relpath(_build.library_path(), HERE), seconds))

    x_np, y_np, x, y = _data(torch, device)
    x_win, y_win = fs.data_windows(x, y, BATCH)
    n_windows = x_win.shape[0]
    init_fn, _ = dense_network(1, units=(H, H, H), device=device)
    lay = fs.FusedLayout(1, H, 3)
    P = lay.n_params
    gen = torch.Generator(device=device).manual_seed(1234)

    def rand(n, lo=None, hi=None, scale=None):
        u = torch.rand((n, P), generator=gen, device=device)
        if scale is not None:
            return (u - 0.5) * scale
        return lo + (hi - lo) * u

    common = dict(mdecay=0.05, scale_grad=float(N_DATA),
                  prior_scale=1.0 / (P * N_DATA), batch_size=BATCH,
                  n_data=N_DATA, h=H)
    eps = 0.01

    # ---- B2 then B1: kernel vs plain at the flagship shapes ----
    n = CHECK_CHAINS
    theta = fs.pack(init_fn(gen, (n,)), lay)
    noise = torch.randn((CHECK_STEPS, n, P), generator=gen, device=device)
    widx = torch.randint(0, n_windows, (CHECK_STEPS, n), generator=gen,
                         device=device, dtype=torch.int32)
    streams = [("injected", dict(noise=noise, widx=widx)),
               ("philox", dict(step0=12345))]
    # adaptation stats inside the EMAs' stable range (g^2 <= v_hat keeps
    # tau' = tau (1 - g^2 / v_hat) + 1 >= 1)
    b2_args = (theta, rand(n, scale=2e-3), rand(n, 1.0, 5.0),
               rand(n, scale=2.0), rand(n, 1.0, 5.0), x_win, y_win, eps,
               987654321)
    b2_labels = ("theta", "v", "tau", "g", "v_hat", "minv", "cost")
    b2_err = 0.0
    for stream, extra in streams:
        got = fs.fused_bnn_multistep_burnin(
            *b2_args, k_steps=CHECK_STEPS, **common, **extra)
        want = fs.fused_bnn_multistep_burnin_ref(
            *b2_args, k_steps=CHECK_STEPS, **common, **extra)
        torch.cuda.synchronize()
        b2_err = max(b2_err, _compare(
            torch, ("B2/" + stream, b2_labels), got, want))
    b1_args = (theta, rand(n, scale=2e-3), rand(n, 0.2, 1.2), x_win, y_win,
               eps, 987654321)
    b1_err = 0.0
    for stream, extra in streams:
        got = fs.fused_bnn_multistep(*b1_args, k_steps=CHECK_STEPS, **common,
                                     **extra)
        want = fs.fused_bnn_multistep_ref(*b1_args, k_steps=CHECK_STEPS,
                                          **common, **extra)
        torch.cuda.synchronize()
        b1_err = max(b1_err, _compare(
            torch, ("B1/" + stream, ("theta", "v", "cost")), got, want))
    del noise, widx

    # ---- times at the main path's shape: 8192 chains, k = 200 ----
    n, k = MAIN_CHAINS, SAMPLE_STEPS
    theta = fs.pack(init_fn(gen, (n,)), lay)
    zeros, ones = torch.zeros_like(theta), torch.ones_like(theta)
    b2_big = (theta, zeros, ones, ones, ones, x_win, y_win, eps, 42)
    timed = {}
    for label, fn in (("B2", fs.fused_bnn_multistep_burnin),
                      ("B2 plain", fs.fused_bnn_multistep_burnin_ref)):
        fn(*b2_big, k_steps=2, **common)  # warm-up
        timed[label], out = _time_ms(
            torch, lambda: fn(*b2_big, k_steps=k, **common))
    minv = out[5]
    b1_big = (out[0], out[1], minv, x_win, y_win, eps, 43)
    for label, fn in (("B1", fs.fused_bnn_multistep),
                      ("B1 plain", fs.fused_bnn_multistep_ref)):
        fn(*b1_big, k_steps=2, step0=k, **common)
        timed[label], _ = _time_ms(
            torch, lambda: fn(*b1_big, k_steps=k, step0=k, **common))
    for label in ("B2", "B1"):
        print("time {} at {} chains x {} steps: kernel {:.2f} ms, plain "
              "{:.2f} ms ({})".format(label, n, k, timed[label],
                                      timed[label + " plain"], card))
    del theta, zeros, ones, b2_big, b1_big, out, minv
    torch.cuda.empty_cache()

    # ---- the main path on a small input: card vs plain versions ----
    print("small main path ({} chains, {} steps) on the card vs the CPU: "
          "max|diff| = {:.3e}".format(
              SMALL["n_chains"], SMALL["n_iters"],
              _small_main_path(torch, x_np, y_np)))

    # ---- the main path: train + predict through the port's BNN ----
    fs.fused_bnn_multistep.launches = 0
    fs.fused_bnn_multistep_burnin.launches = 0
    bnn = BayesianNeuralNetwork(
        network="dense", step_impl="fused", n_chains=MAIN_CHAINS,
        n_nets=MAIN_CHAINS, burn_in_steps=BURN_IN,
        sample_steps=SAMPLE_STEPS, n_iters=BURN_IN + SAMPLE_STEPS,
        device="cuda")
    t0 = time.perf_counter()
    bnn.train(x_np, y_np)
    train_s = time.perf_counter() - t0
    x_grid = np.linspace(0.0, 1.0, 200)[:, None]
    t0 = time.perf_counter()
    mean, var = bnn.predict(x_grid)
    predict_s = time.perf_counter() - t0
    launches = {"B1": fs.fused_bnn_multistep.launches,
                "B2": fs.fused_bnn_multistep_burnin.launches}
    mse = float(np.mean((mean - np.sinc(x_grid[:, 0] * 10 - 5)) ** 2))
    print("main path: {} chains, {} burn-in + {} sampling steps, {} "
          "samples; train {:.2f} s, predict {:.3f} s; launches {}".format(
              MAIN_CHAINS, BURN_IN, SAMPLE_STEPS, len(bnn.samples["w2"]),
              train_s, predict_s, launches))
    if not (np.isfinite(mean).all() and np.isfinite(var).all()):
        raise AssertionError("predictions are not finite")
    if mean.shape != (200,) or var.shape != (200,):
        raise AssertionError("prediction shapes {} {}".format(
            mean.shape, var.shape))
    if not mse < 0.1:
        raise AssertionError("predictive MSE {} >= 0.1".format(mse))
    if min(launches.values()) < 1:
        raise AssertionError("a kernel was not launched: {}".format(launches))
    print("predictive MSE on sinc: {:.3e} (gate 0.1)".format(mse))
    for phase, steps in (("burn_in", BURN_IN), ("sampling", SAMPLE_STEPS)):
        seconds = bnn.phase_seconds[phase]
        print("{} update-steps/s: {:.4e} ({} chains x {} steps in {:.3f} s; "
              "{})".format(phase, MAIN_CHAINS * steps / seconds, MAIN_CHAINS,
                           steps, seconds, card))

    records = [
        {"name": "fused_bnn_multistep_burnin", "route": "cuda",
         "source": "pysgmcmc_tpu_torch/csrc/fused_step.cu",
         "replaces": "pysgmcmc_tpu/ops/fused_step.py:2823",
         "launches": launches["B2"], "max_abs_err": b2_err,
         "ms": timed["B2"], "plain_ms": timed["B2 plain"]},
        {"name": "fused_bnn_multistep", "route": "cuda",
         "source": "pysgmcmc_tpu_torch/csrc/fused_step.cu",
         "replaces": "pysgmcmc_tpu/ops/fused_step.py:1007",
         "launches": launches["B1"], "max_abs_err": b1_err,
         "ms": timed["B1"], "plain_ms": timed["B1 plain"]},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
