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
B5-psgld, B5-rsghmc, B5-sgnht where they exist), at f32 state, and where
the tree takes bf16 state also B1, B2, B5-sgld, B5-rsghmc and B5-sgnht at
bf16 state ("B1 (bf16)", ...); then, at f32 state and operands, the
median of 20 launches of one step at 8192 chains of each one-step fused
kernel (B3, B4-sgld, and B4-psgld, B4-rsghmc, B4-sgnht where they exist)
and each slim kernel (B7, B8-sgld, B8-psgld, B8-rsghmc, B8-sgnht, B9-sghmc,
B9-sgld; on the flagship's 5,252 parameters; and where the tree has them
B10 on the 5,376 padded columns, B7-mask on the 6,016-column slab and B7'
on the dense network's leaves, each of these two also with a bf16
gradient, B7' then with its bf16 copy of theta: "B7-mask (bf16)",
"B7' (bf16)"), with the slim kernels'
``ptxas`` report too; where the tree trains wide networks, B2, B1, B6 and
B5-sgld at hidden width 100 (state in device memory), median of 5
launches of 20 steps at 8192 chains ("B1 (H=100)", ...); where the tree
has the MXU-CLT and paired instantiations, each of these multi-step and
one-step records again with ``noise_impl="hadamard_clt"`` ("B1 (clt)",
"B1 (bf16, clt)", "B1 (H=100, clt)", ...) and, for B1, B2, B3, B5-* and B6,
with ``pair_dots=True`` ("B1 (paired)", ...), with their ``ptxas``
reports; B2 at width 100 also at bf16 state ("B2 (H=100, bf16)"); and
the SVGD transport B11 at the flagship's 4096 particles x 5,252 parameters
(median of 20 launches, on particles 0.3 N(0, 1), gradients N(0, 1) and
their median bandwidth), with its ``ptxas`` report.  The constants, the
data, the register report and the timing (CUDA events on a spinning
stream) are ``chip_smoke.py``'s.  To compare two trees, run it on both in turns in one
call (A, B, B, A): a card's times move between calls more than within one.
``--only B1,B5-sgld`` times only the records of those kernels (every
variant of each, at both widths; the states the others would hand on are
still computed, untimed): for stub breakdowns and trial variants of a few
kernels.  The A/B that compares a change with its parent times every
record, without it.
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
    parser.add_argument("--only", default=None,
                        help="comma-separated kernels (B1, B5-sgld, ...) "
                             "whose records alone are timed")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    only = None if args.only is None else set(args.only.split(","))

    def selected(name):
        return only is None or name.split(" ")[0] in only

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    cs._import_port(root)
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.ops import _build, fused_step as fs
    from pysgmcmc_tpu_torch.ops import slim_update as su

    print(cs._card())
    _build.build()
    with open(_build.log_path("fused_step")) as f:
        registers = cs._ptxas_report(f.read(), complete=False)
    with open(_build.log_path("slim_update")) as f:
        registers.update(cs._ptxas_report(
            f.read(), "slim_kernel", cs.SLIM_INSTANCES, complete=False,
            tags=(" (bf16)",), layouts=cs.SLIM_LAYOUTS))
    variants = "fused_step_clt" in _build.SOURCES
    if variants:  # the CLT and paired instantiations
        for source, tag in (("fused_step_clt", "clt"),
                            ("fused_step_paired", "paired")):
            with open(_build.log_path(source)) as f:
                registers.update({
                    cs._record(name, tag): line for name, line in
                    cs._ptxas_report(f.read(), complete=False).items()})

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
    inputs = {}  # record -> the arguments it was timed on

    def timed(name, fn, state, eps, kw, k=k):
        """Median ms of REPEATS launches of k steps; returns the outputs."""
        inputs[name] = (fn, state, eps, kw, k)

        def run(steps=k):
            return fn(*state, x_win, y_win, eps, 7, k_steps=steps, **kw)

        if not selected(name):  # only the state it hands on
            return run()
        run(2)  # warm-up
        runs = sorted((cs._time_ms(torch, run) for _ in range(REPEATS)),
                      key=lambda r: r[0])
        ms[name] = runs[REPEATS // 2][0]
        return runs[0][1]

    burned = timed("B2", fs.fused_bnn_multistep_burnin,
                   (theta, zeros, ones, ones, ones), cs.EPS,
                   dict(sg, mdecay=0.05))
    timed("B1", fs.fused_bnn_multistep, (burned[0], burned[1], burned[5]),
          cs.EPS, dict(sg, mdecay=0.05))
    minv_sghmc = burned[5]
    out = timed("B6", fs.fused_bnn_multistep_burnin_sgld,
                (theta, ones, ones, ones), cs.EPS_SGLD, dict(sg, a_coef=1.0))
    timed("B5-sgld", fs.fused_bnn_multistep_sgld, (out[0], out[4]),
          cs.EPS_SGLD, dict(sg, a_coef=1.0))
    minv_sgld = out[4]
    if hasattr(fs, "fused_bnn_multistep_psgld"):
        eps = cs.B8_EPS
        timed("B5-psgld", fs.fused_bnn_multistep_psgld,
              (theta, 1e-4 * ones), eps["PSGLD"], sg)
        timed("B5-rsghmc", fs.fused_bnn_multistep_rsghmc, (theta, normal),
              eps["RelativisticSGHMC"], base)
        timed("B5-sgnht", fs.fused_bnn_multistep_sgnht,
              (theta, normal, torch.ones(n, device=device)), eps["SGNHT"],
              sg)
    if hasattr(fs, "STATE_DTYPES"):  # the tree takes bf16 state
        bf = torch.bfloat16
        out = timed("B2 (bf16)", fs.fused_bnn_multistep_burnin,
                    (theta, zeros.to(bf), ones, ones, ones), cs.EPS,
                    dict(sg, mdecay=0.05, state_dtype=bf))
        timed("B1 (bf16)", fs.fused_bnn_multistep,
              (out[0], out[1], out[5].to(bf)), cs.EPS,
              dict(sg, mdecay=0.05, state_dtype=bf))
        timed("B5-sgld (bf16)", fs.fused_bnn_multistep_sgld,
              (theta, ones.to(bf)), cs.EPS_SGLD, dict(sg, a_coef=1.0))
        timed("B5-rsghmc (bf16)", fs.fused_bnn_multistep_rsghmc,
              (theta, normal.to(bf)), eps["RelativisticSGHMC"],
              dict(base, state_dtype=bf))
        timed("B5-sgnht (bf16)", fs.fused_bnn_multistep_sgnht,
              (theta, normal.to(bf), torch.ones(n, device=device)),
              eps["SGNHT"], dict(sg, state_dtype=bf))

    def time_variants(names):
        """Each multi-step record of ``names`` again as its CLT and, where
        the kernel has one, paired instantiation."""
        for name in names:
            if not selected(name):
                continue
            fn, state, eps, kw, steps = inputs[name]
            for variant, extra in cs.VARIANT_KW.items():
                if not variant or (variant == "paired" and (
                        name.split(" ")[0] not in cs.PAIRED_KERNELS
                        or "H=" in name or name == "B5-sgld (bf16)")):
                    continue
                timed(cs._record(name, variant), fn, state, eps,
                      dict(kw, **extra), steps)

    if variants:
        time_variants(list(inputs))

    def timed_one(name, fn, args, kw):
        """Median ms of cs.ONE_STEP_TIMED launches of one step."""
        if not selected(name):
            return
        fn(*args, **kw)  # warm-up
        ms[name] = cs._median_ms(torch, lambda: fn(*args, **kw),
                                 cs.ONE_STEP_TIMED)

    # one-step kernels on each chain's Philox window, f32 state
    sel = fs.gather_batch(x_win, y_win, fs.philox_windows(
        46, 0, n, x_win.shape[0], device))
    eps = cs.B8_EPS
    one_step = {"B3": (fs.fused_bnn_step, (theta, zeros, minv_sghmc),
                       cs.EPS, dict(sg, mdecay=0.05)),
                "B4-sgld": (fs.fused_bnn_step_sgld, (theta, minv_sgld),
                            cs.EPS_SGLD, dict(sg, a_coef=1.0))}
    if hasattr(fs, "fused_bnn_step_psgld"):
        one_step.update({
            "B4-psgld": (fs.fused_bnn_step_psgld, (theta, 1e-4 * ones),
                         eps["PSGLD"], sg),
            "B4-rsghmc": (fs.fused_bnn_step_rsghmc, (theta, normal),
                          eps["RelativisticSGHMC"], base),
            "B4-sgnht": (fs.fused_bnn_step_sgnht,
                         (theta, normal, torch.ones(n, device=device)),
                         eps["SGNHT"], sg)})
    for name, (fn, state, e, kw) in one_step.items():
        timed_one(name, fn, (*state, *sel, e, 46), dict(kw, step=0))
        if variants:
            timed_one(cs._record(name, "clt"), fn, (*state, *sel, e, 46),
                      dict(kw, step=0, **cs.VARIANT_KW["clt"]))
            if name == "B3":
                timed_one(cs._record(name, "paired"), fn,
                          (*state, *sel, e, 46),
                          dict(kw, step=0, **cs.VARIANT_KW["paired"]))
    # slim kernels, f32 operands: a unit gradient and momentum scale
    del sel
    grad, v = normal, 1e-2 * normal
    pr = dict(prior_scale=base["prior_scale"])
    sg_slim = dict(pr, scale_grad=float(cs.N_DATA))
    slim = {
        "B7": (su.slim_sghmc_update, (theta, v, grad, ones, None), cs.EPS,
               dict(sg_slim, mdecay=0.05)),
        "B8-sgld": (su.slim_sgld_update, (theta, grad, ones, None),
                    cs.EPS_SGLD, dict(sg_slim, a_coef=1.0)),
        "B9-sghmc": (su.slim_sghmc_burnin_update,
                     (theta, v, ones, ones, ones, grad, None), cs.EPS,
                     dict(sg_slim, mdecay=0.05)),
        "B9-sgld": (su.slim_sgld_burnin_update,
                    (theta, ones, ones, ones, grad, None), cs.EPS_SGLD,
                    dict(sg_slim, a_coef=1.0))}
    if hasattr(su, "slim_psgld_update"):
        slim.update({
            "B8-psgld": (su.slim_psgld_update,
                         (theta, 1e-4 * ones, grad, None), eps["PSGLD"],
                         dict(sg_slim, alpha=0.99, lambda_reg=1e-5)),
            "B8-rsghmc": (su.slim_rsghmc_update, (theta, v, grad, None),
                          eps["RelativisticSGHMC"],
                          dict(pr, d_coef=1.0, bhat=0.0, mass=1.0,
                               speed_of_light=1.0)),
            "B8-sgnht": (su.slim_sgnht_update,
                         (theta, v, grad, None,
                          torch.ones(n, device=device)), eps["SGNHT"],
                         dict(sg_slim, a_diff=1.0))})
    if hasattr(su, "slim_sghmc_update_tree"):  # B10, B7 mask, B7'
        from pysgmcmc_tpu_torch.ops import fused_update as fu
        from pysgmcmc_tpu_torch.parallel import packed

        pad = fu.pad_dim(lay.n_params) - lay.n_params

        def padded(t):
            return torch.nn.functional.pad(t, (0, pad), value=1.0)

        slim["B10"] = (fu.fused_sghmc_update,
                       (padded(theta), padded(v)) + (padded(ones),) * 4
                       + (padded(grad), cs.EPS, False), 0, {})
        tree = {k: {name: leaf.contiguous() for name, leaf in
                    fs.unpack(t, lay).items()} for k, t in
                (("theta", theta), ("v", v), ("grad", grad), ("minv", ones))}
        spec = packed.make_pack_spec({k: t[0] for k, t in
                                      tree["theta"].items()})
        slab = [packed.pack_tree(spec, tree[k])
                for k in ("theta", "v", "grad", "minv")]
        slim["B7-mask"] = (su.slim_sghmc_update,
                           (*slab, packed.pack_mask(spec, device=device)),
                           cs.EPS, dict(sg_slim, mdecay=0.05))
        slim["B7-mask (bf16)"] = (su.slim_sghmc_update,
                                  (*slab[:2], slab[2].to(torch.bfloat16),
                                   *slab[3:], packed.pack_mask(
                                       spec, device=device)),
                                  cs.EPS, dict(sg_slim, mdecay=0.05))
        slim["B7'"] = (su.slim_sghmc_update_tree,
                       [tree[k] for k in ("theta", "v", "grad", "minv")],
                       cs.EPS, dict(sg_slim, mdecay=0.05))
        slim["B7' (bf16)"] = (su.slim_sghmc_update_tree,
                              [tree["theta"], tree["v"],
                               {k: g.to(torch.bfloat16)
                                for k, g in tree["grad"].items()},
                               tree["minv"]],
                              cs.EPS, dict(sg_slim, mdecay=0.05,
                                           emit_bf16=True))
    for name, (fn, args, e, kw) in slim.items():
        if name == "B10":  # eps and the phase come with the state
            timed_one(name, fn, (*args, 47), dict(step=0, mdecay=0.05,
                                                  scale_grad=cs.N_DATA))
            continue
        timed_one(name, fn, (*args, e, 47), dict(kw, step=0))
    if hasattr(fs, "fused_placement"):  # the tree trains wide networks
        del theta, zeros, ones, normal, grad, v, burned, out
        wide = fs.FusedLayout(1, cs.WIDE_H, 3)
        theta = fs.pack(dense_network(1, units=(cs.WIDE_H,) * 3,
                                      device=device)[0](
            gen, (cs.WIDE_CHAINS,)), wide)
        ones = torch.ones_like(theta)
        kw = dict(base, h=cs.WIDE_H,
                  prior_scale=1.0 / (wide.n_params * cs.N_DATA),
                  scale_grad=float(cs.N_DATA))
        tag, steps = " (H={})".format(cs.WIDE_H), cs.WIDE_STEPS
        out = timed("B2" + tag, fs.fused_bnn_multistep_burnin,
                    (theta, torch.zeros_like(theta), ones, ones, ones),
                    cs.EPS, dict(kw, mdecay=0.05), steps)
        timed("B1" + tag, fs.fused_bnn_multistep, (out[0], out[1], out[5]),
              cs.EPS, dict(kw, mdecay=0.05), steps)
        out = timed("B6" + tag, fs.fused_bnn_multistep_burnin_sgld,
                    (theta, ones, ones, ones), cs.EPS_SGLD,
                    dict(kw, a_coef=1.0), steps)
        timed("B5-sgld" + tag, fs.fused_bnn_multistep_sgld,
              (out[0], out[4]), cs.EPS_SGLD, dict(kw, a_coef=1.0), steps)
        wide_names = ["B2", "B1", "B6", "B5-sgld"]
        if hasattr(fs, "STATE_DTYPES"):
            wide_names.append("B2 (H={}, bf16)".format(cs.WIDE_H))
            timed(wide_names[-1], fs.fused_bnn_multistep_burnin,
                  (theta, torch.zeros_like(theta).to(torch.bfloat16), ones,
                   ones, ones), cs.EPS,
                  dict(kw, mdecay=0.05, state_dtype=torch.bfloat16), steps)
        if variants:
            time_variants([name if "H=" in name else name + tag
                           for name in wide_names])
        del theta, ones, out
    # the SVGD transport at the flagship's shape
    from pysgmcmc_tpu_torch.ops import pairwise
    from pysgmcmc_tpu_torch.ops import svgd_streaming as ss

    with open(_build.log_path("svgd_streaming")) as f:
        registers.update(cs._ptxas_svgd(f.read(), complete=False))
    sx = 0.3 * torch.randn((cs.SVGD_PARTICLES, lay.n_params), generator=gen,
                           device=device)
    sg = torch.randn(sx.shape, generator=gen, device=device)
    sh = pairwise.median_bandwidth(pairwise.squared_distance_matrix(sx),
                                   cs.SVGD_PARTICLES)
    timed_one("B11", ss.svgd_phi_streaming, (sx, sg, sh), {})
    print(json.dumps({"root": root, "ptxas": registers, "ms": ms,
                      "chains": n, "steps": k, "repeats": REPEATS,
                      "svgd_shape": list(sx.shape)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
