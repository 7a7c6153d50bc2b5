#!/usr/bin/env python3
"""Device times of the fused multi-step kernels of one checkout, for
comparing two trees on one card.

    python3 kernel_times.py [--root DIR]

Imports ``pysgmcmc_tpu_torch`` from ``--root`` (by default the checkout
that holds this file), builds its CUDA kernels, and prints the card's name
and power limit, then one JSON line: the ``ptxas`` report of each fused
kernel the tree has, and the median device time of 5 launches of 200 steps
at 8192 chains on the flagship network (3x50 tanh, 100 sinc points, batch
20) of each multi-step fused kernel it has (B1, B2, B5-sgld, B6, and
B5-psgld, B5-rsghmc, B5-sgnht where they exist).  The constants, the data,
the register report and the timing (CUDA events on a spinning stream) are
``chip_smoke.py``'s.  To compare two trees, run it on both in turns in one
call (A, B, B, A): a card's times move between calls more than within one.
Needs a CUDA device; exits non-zero without one.
"""

import argparse
import json
import os
import sys

import chip_smoke as cs

REPEATS = 5


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=cs.HERE,
                        help="the checkout whose package is timed")
    root = os.path.abspath(parser.parse_args(argv).root)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    cs._import_port(root)
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.ops import _build, fused_step as fs

    print(cs._card())
    _build.build()
    with open(_build.log_path("fused_step")) as f:
        registers = cs._ptxas_report(f.read(), complete=False)

    device = torch.device("cuda")
    n, k = cs.MAIN_CHAINS, cs.SAMPLE_STEPS
    x, y = cs._data(torch, device)[2:]
    x_win, y_win = fs.data_windows(x, y, cs.BATCH)
    lay = fs.FusedLayout(1, cs.H, 3)
    gen = torch.Generator(device=device).manual_seed(1234)
    theta = fs.pack(dense_network(1, units=(cs.H,) * 3, device=device)[0](
        gen, (n,)), lay)
    zeros, ones = torch.zeros_like(theta), torch.ones_like(theta)
    normal = torch.randn(theta.shape, generator=gen, device=device)
    base = dict(prior_scale=1.0 / (lay.n_params * cs.N_DATA),
                batch_size=cs.BATCH, n_data=cs.N_DATA, h=cs.H)
    sg = dict(base, scale_grad=float(cs.N_DATA))
    ms = {}

    def timed(name, fn, state, eps, kw):
        """Median ms of REPEATS launches of k steps; returns the outputs."""
        def run(steps=k):
            return fn(*state, x_win, y_win, eps, 7, k_steps=steps, **kw)

        run(2)  # warm-up
        runs = sorted((cs._time_ms(torch, run) for _ in range(REPEATS)),
                      key=lambda r: r[0])
        ms[name] = runs[REPEATS // 2][0]
        return runs[0][1]

    out = timed("B2", fs.fused_bnn_multistep_burnin,
                (theta, zeros, ones, ones, ones), cs.EPS,
                dict(sg, mdecay=0.05))
    timed("B1", fs.fused_bnn_multistep, (out[0], out[1], out[5]), cs.EPS,
          dict(sg, mdecay=0.05))
    out = timed("B6", fs.fused_bnn_multistep_burnin_sgld,
                (theta, ones, ones, ones), cs.EPS_SGLD, dict(sg, a_coef=1.0))
    timed("B5-sgld", fs.fused_bnn_multistep_sgld, (out[0], out[4]),
          cs.EPS_SGLD, dict(sg, a_coef=1.0))
    if hasattr(fs, "fused_bnn_multistep_psgld"):
        eps = cs.B8_EPS
        timed("B5-psgld", fs.fused_bnn_multistep_psgld,
              (theta, 1e-4 * ones), eps["PSGLD"], sg)
        timed("B5-rsghmc", fs.fused_bnn_multistep_rsghmc, (theta, normal),
              eps["RelativisticSGHMC"], base)
        timed("B5-sgnht", fs.fused_bnn_multistep_sgnht,
              (theta, normal, torch.ones(n, device=device)), eps["SGNHT"],
              sg)
    print(json.dumps({"root": root, "ptxas": registers, "ms": ms,
                      "chains": n, "steps": k, "repeats": REPEATS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
