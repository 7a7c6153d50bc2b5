#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pysgmcmc_tpu_torch/csrc`` (one
``nvcc`` per source, three per fused source, in parallel) and prints their ``ptxas`` registers and
spills, holds each of the twenty-three kernels against its plain PyTorch
version on the card (flagship shapes, from burned-in states, injected noise
and the Philox stream, each check beside the plain version's own floor):
the fused kernels B1, B2, B3, B4-sgld, B4-psgld, B4-sgnht, B4-rsghmc,
B5-sgld, B5-psgld, B5-sgnht, B5-rsghmc, B6, the slim kernels B7,
B8-sgld, B8-psgld, B8-rsghmc, B8-sgnht, B9-sghmc, B9-sgld (also with a
per-chain eps row), FusedSGHMC's B10 (both phases), B7 with its mask
(the packed slab, f32 and bf16 gradient) and B7' (the stacked tree, and
with bf16 gradient and the bf16 copy of theta), and the SVGD transport
B11 (on the flagship's ensemble after 50 SVGD steps and at the JAX
package's test shapes).  Every bf16
instantiation (bf16 momentum and minv in the fused kernels, bf16 v, minv
and gradient in the slim kernels) is held against its plain version over
at most 3 steps with one bf16 ulp per value and step on top, its share of
differing bf16 values beside a witness (the plain version on the CPU);
the slim ones at the flagship shape on the same three streams as at f32;
and
B1, B2, B5-sgld and B6 at hidden width 100, whose state lives in device
memory (B6's theta and gradient in shared memory: the burn-in EMAs stay in
device memory in both placements; every launch's placement is held to the
library's own count), and B6 at width 114, its state in device memory
(also two launches of k steps against one of 2k, bit for bit).  It times
every kernel and variant at the main path's shape (a multi-step kernel as
the median of 5 launches; B11 beside the dense path's phi and the median
bandwidth, with its f32 and tensor-core bounds and the clusters of 2
blocks the card holds), checks the one-step driver against the
multi-step driver at f32 and at bf16 state and the chains-on-lanes
drivers against the fused drivers on the dense network for all five
samplers, and the small main paths on the card against the CPU, then trains
and predicts the flagship BNNs (3x50 tanh, 8192 chains, sinc data) through
``pysgmcmc_tpu_torch.models.BayesianNeuralNetwork``: all five samplers on
the fused path (``network="dense"``; pSGLD, relativistic SGHMC and SGNHT
burn in on the lanes driver) and all five on the lanes path
(``network="reference"``), SGHMC under ``compute_dtype=torch.bfloat16`` on
both paths (with predict's serving rate in f32 and bf16 at 10,000 points),
short bf16 lanes runs of the other four samplers, the 3x100 network on the
fused path (SGHMC, and a short SGLD run) and a short SGLD run of the
3x114 network at 8192 chains, FusedSGHMC
over the reference network (8192 chains, 3000 + 200 steps on B10; B10, B7
mask and B7' checked and timed from its state) and from its state 200
sampling steps each of ``sample_chain_packed`` (B7 mask, bf16 passes and
f32 passes, the slot padding checked to stay 0) and ``sample_chain_stacked`` (B7', f32 and
``bf16_params``), the packed and stacked drivers against the lanes driver
over 16 steps, and the SVGD
flagship (4096 particle networks x
500 steps on B11, after its first 10 steps on B11, on the plain phi and on
the dense path, and a 64-particle SVGD path card vs CPU beside the same
path on the plain phi and the dense path), and takes one profiler trace of
lanes steps.
Each kernel's launches are counted over the paths that run it (the fused
flagships for B1/B2, B5-sgld/B6 and B5-psgld, B5-rsghmc, B5-sgnht, the
one-step driver for B3 and B4-*, the lanes flagships for B7/B9-sghmc and
B8-sgld/B9-sgld, both flagships of each sampler for B8-psgld, B8-rsghmc
and B8-sgnht, the SVGD flagship for B11, the FusedSGHMC flagship for B10,
the packed flagships for B7 mask (bf16 passes at the default
``compute_dtype``, f32 passes at ``compute_dtype=None``), the stacked
flagships for B7' (f32 and bf16); the bf16 flagships
and the bf16 drivers for the bf16 instantiations, the 3x100 and 3x114
runs for the wide records).
It prints each fused launch's placement (shared or device memory) and its
own wall time;
the second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA device, or without
the package beside this script, it exits non-zero before printing any
result.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_DATA, BATCH, H = 100, 20, 50
SEED = 987654321
CHECK_CHAINS, CHECK_STEPS = 256, 16
MAIN_CHAINS, BURN_IN, SAMPLE_STEPS = 8192, 3000, 200
ONE_STEP_TIMED = 20          # launches timed per one-step kernel (median)
DRIVER_CHAINS, DRIVER_SAMPLES, DRIVER_KEEP = 1024, 2, 10  # 20 steps
BURNED_IN = 200  # burn-in steps at EPS before the kernel checks and drivers
# kernel vs plain version, per output: |kernel - plain| <= REL_TOL * the
# largest |plain| in the same chain's row (one row for costs and vectors), so
# no chain sets the limit for another.  The two sum the 20x50 dot products in
# different orders and precisions (the fused kernels' 3xTF32 tensor-core
# sums vs cuBLAS bmm in f32) and use different libm builds (tanhf/logf/cosf
# within 2 ulp; the fused kernels' fast cosine and root within 2.4e-6 of a
# normal).  Every check starts from the
# state a BURNED_IN-step burn-in at EPS leaves (as the main path hands it to
# the kernels, with minv in [1e-3, 1e4]), and also runs the plain
# version from theta * (1 + 1e-7 xi): that moves the outputs by the floor,
# which must stay below REL_TOL / 4, so that 2e-4 flags real disagreement
# and not rounding amplified by the path.
REL_TOL = 2e-4
# SGHMC moves theta by eps**2 * minv * g, SGLD by eps * minv * g: SGLD's
# chains at EPS amplify a 1e-7 nudge beyond the floor within 16 steps (the
# script measures and prints it, "not checked"), so its kernels are checked
# over CHECK_STEPS steps at EPS_SGLD and over one step at EPS.
EPS, EPS_SGLD = 0.01, 1e-3
# the main paths at a small size, run on the card and on the CPU from the
# same initial weights and seed.  SGHMC on the degenerate stream (zero
# noise, window 0).  SGLD there is preconditioned gradient descent on one
# window at the edge of stability and amplifies a 1e-7 nudge to order one,
# so it runs on the Philox stream, which the plain versions reproduce, at
# EPS_SGLD (the script prints the floor at EPS).
# The lanes path (reference network) the same way; on the degenerate stream
# its SGLD floor is 0.19 (CPU), so SGLD runs on the Philox stream there too.
SMALL = {"SGHMC": dict(network="dense", step_impl="fused", n_chains=4,
                       n_nets=8, burn_in_steps=64, sample_steps=16,
                       n_iters=96, log_every=None, noise_impl="zero")}
SMALL["SGLD"] = dict(SMALL["SGHMC"], noise_impl="auto",
                     stepsize_schedule=EPS_SGLD)
SMALL_LANES = {method: dict(config, network="reference", step_impl="lanes")
               for method, config in SMALL.items()}
# pSGLD, relativistic SGHMC and SGNHT have no burn-in machinery and run on
# the lanes path only.  Relativistic SGHMC and SGNHT run their small paths
# on the Philox stream at their flagship stepsizes (B8_EPS).  pSGLD's
# preconditioner 1 / (lambda + sqrt(v)) reaches 1 / lambda = 1e5 where a
# gradient is near 0, and there a 1e-7 nudge moves the Philox-stream path
# beyond the floor (CPU: 2.1e-4 at 1e-3, 6.3e-5 at 1e-4), so its small path
# runs on the degenerate stream at 1e-4 (CPU floor 1.4e-7) and the script
# prints the Philox floor at 1e-3.
B8_EPS = {"PSGLD": 1e-3, "RelativisticSGHMC": 1e-3, "SGNHT": 3e-4}
for _method, _eps in B8_EPS.items():
    SMALL_LANES[_method] = dict(SMALL_LANES["SGLD"], stepsize_schedule=_eps)
SMALL_LANES["PSGLD"].update(noise_impl="zero", stepsize_schedule=1e-4)
# their fused paths (burn-in on the lanes driver, sampling on B5-*) the same
for _method in B8_EPS:
    SMALL[_method] = dict(SMALL_LANES[_method], network="dense",
                          step_impl="fused")
# The flagship MSE gate is 0.1 (BASELINE.md), for SGNHT too.  In the JAX
# package SGNHT sits near it on sinc (CPU, 64 chains, 3000 + 200 steps:
# 0.097 at 3e-4, 0.078 at 512 chains), a bias that more chains barely move.
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# f32 outside the tensor cores, and HBM3 bandwidth.
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# and the dense TF32 tensor-core peak (3xTF32: three passes of split
# operands)
TF32_FLOPS = 495e12
# ptxas names the instantiations fused_kernel<rule, burn-in, gathered,
# device, bf16 v> and slim_kernel<rule, burn-in, bf16 operands>
INSTANCES = {(0, 0, 0): "B1", (0, 1, 0): "B2", (0, 0, 1): "B3",
             (1, 0, 1): "B4-sgld", (1, 0, 0): "B5-sgld", (1, 1, 0): "B6",
             (2, 0, 1): "B4-psgld", (2, 0, 0): "B5-psgld",
             (3, 0, 1): "B4-rsghmc", (3, 0, 0): "B5-rsghmc",
             (4, 0, 1): "B4-sgnht", (4, 0, 0): "B5-sgnht"}
SLIM_INSTANCES = {(0, 0): "B7", (1, 0): "B8-sgld", (2, 0): "B8-psgld",
                  (3, 0): "B8-rsghmc", (4, 0): "B8-sgnht", (0, 1): "B9-sghmc",
                  (1, 1): "B9-sgld", (5, 1): "B10"}
# slim_kernel's layout parameter -> the name's suffix: the flat row, B7's
# mask row, B7''s stacked tree
SLIM_LAYOUTS = {0: "", 1: "-mask", 2: "'"}
# SVGD (kernel B11): the flagship's ensemble of 3x50 reference networks
# (5,252 parameters each) at the BNN's default stepsize; 4096 particles is
# the largest ensemble whose streaming bandwidth is exact (the sampler's
# bandwidth_subsample).  Its kernel checks start from the ensemble after
# SVGD_STATE_STEPS steps and also take the shapes of the JAX package's
# streaming tests; the small main path runs SVGD_SMALL particles.
SVGD_PARTICLES, SVGD_STEPS, SVGD_STATE_STEPS = 4096, 500, 50
SVGD_SMALL, SVGD_SMALL_STEPS, SVGD_TWICE_STEPS = 64, 50, 10
SVGD_SHAPES = ((256, 3), (128, 130), (100, 2), (97, 5), (130, 3))
SVGD_TIMED = 20  # launches of B11 timed (median)
# B11's SVGD paths against the plain phi: the samples' distance is held to
# this many times that of a witness, the same path with another order of
# summation (the plain phi on the card against the CPU, the dense path)
SVGD_WITNESS = 4.0
MULTI_TIMED = 5  # launches of each multi-step kernel timed (median)
# bf16 state (JAX's state_dtype=bfloat16): each kernel is held against its
# plain version over BF16_STEPS <= 3 steps (Philox stream) from the
# burned-in states.  A value whose f32 result straddles a bf16 rounding
# boundary rounds one ulp (2**-8 of itself) apart in the two, far above
# REL_TOL, so each bf16 output may differ by one bf16 ulp per element per
# step, theta by REL_TOL plus one ulp of its row's largest momentum (at
# most of its own largest value) per step; the share of bf16 values that differ at all is held to BF16_WITNESS
# times that of a witness, the plain version on the card against the plain
# version on the CPU (the same arithmetic in another summation order), or
# to BF16_WITNESS * BF16_FLOOR where the witness flips fewer.
BF16_STEPS, BF16_WITNESS, BF16_FLOOR = 3, 4.0, 1e-4
# the wide fused kernels (JAX's 128-slot layout takes H <= 114): hidden
# width 100 at depth 3 (P = 20,502), where the state of B1, B2 and B5-sgld
# does not fit a block's shared memory and lives in device memory (B6's
# theta and gradient fit: the burn-in EMAs stay in device memory in both
# placements); and B6 again at DEVICE_H, the widest the fused path takes
# (fused_step.MAX_HIDDEN; P = 26,564), where its state lives in device
# memory too.  Their flagships run WIDE_CHAINS chains, and they are timed
# there per launch of WIDE_STEPS steps (the plain version at width 100
# takes seconds per step)
WIDE_H, WIDE_CHAINS, WIDE_STEPS = 100, 8192, 20
DEVICE_H = 114
# The wide SGLD check states, burned in by B6, amplify a 1e-7 nudge of
# theta beyond REL_TOL / 4 over CHECK_STEPS steps at EPS_SGLD (on the
# H100: at width 100 B6 9.6e-3 on injected noise and 4.6e-2 on Philox,
# still 4.5e-2 over 8 steps, B5-sgld 2.9e-2 and 7.1e-3; at width 114 B6
# 7.3e-4 and 2.7e-2, still 9.1e-5 on injected noise over 2 steps), so
# over that many steps the check cannot tell rounding from disagreement.
# These entries are checked over the steps below at EPS_SGLD; their
# CHECK_STEPS floors are printed, unchecked (PERF.md section 6).  (B6 at
# width 114 is also held to k + k == 2k steps, bit for bit.)
WIDE_SGLD_STEPS = {("B6", WIDE_H): 4, ("B5-sgld", WIDE_H): 8,
                   ("B6", DEVICE_H): 1}
# predict's serving rate: queries at 8192 members x PREDICT_POINTS points
PREDICT_POINTS, PREDICT_TIMED = 10_000, 3
PROFILED_STEPS = 20  # lanes burn-in steps in the profiler trace
HOST_ROUNDS = 3  # timings of those steps on the host's clock, least kept
# device clock cycles the stream spins before a timed call (_time_ms),
# about 10 ms at the H100's 1.98 GHz: longer than any timed wrapper's host
# work
SPIN_CYCLES = 20_000_000


def _import_port(root=HERE):
    """Import the package of the checkout at ``root``, and only that one."""
    sys.path.insert(0, root)
    import pysgmcmc_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(pysgmcmc_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != root:
        raise SystemExit("pysgmcmc_tpu_torch was imported from {}, not from "
                         "the checkout at {}".format(pkg_dir, root))


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(
        ).splitlines()[0]


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
    """Device ms of ``fn``'s work: the stream spins first, so that ``fn``'s
    host work (validation, allocation, the launch itself) overlaps the spin
    and the events bracket device time alone.  Without the spin a one-step
    kernel's time takes in its wrapper's host time, which moves with the
    load of a shared host."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _median_ms(torch, fn, repeats):
    times = sorted(_time_ms(torch, fn)[0] for _ in range(repeats))
    return times[len(times) // 2]


def _rows(t):
    """An output as rows: one per chain (or sample) where each holds several
    values, else a single row."""
    if t.ndim > 1 and t[0].numel() > 1:
        return t.reshape(t.shape[0], -1)
    return t.reshape(1, -1)


def _rel_err(got, want):
    """The largest |got - want| of each row over that row's largest |want|,
    maximised over the rows."""
    g, w = _rows(got), _rows(want)
    return float(((g - w).abs().amax(1) / w.abs().amax(1)).max())


def _nudge(torch, theta):
    """``theta * (1 + 1e-7 xi)``: where the plain version takes this start,
    its outputs measure how far the path amplifies a rounding-sized
    difference (the check's floor)."""
    gen = torch.Generator(device=theta.device).manual_seed(99)
    return theta * (1.0 + 1e-7 * torch.randn(
        theta.shape, generator=gen, device=theta.device))


def _ulp_bf16(torch, t):
    """One bf16 ulp of each |value| (2**-7 of its binade; 0 at 0)."""
    t = t.abs()
    return torch.where(t > 0, torch.exp2(torch.floor(torch.log2(
        t.clamp_min(1e-38))) - 7), torch.zeros_like(t))


def _bf16_flips(torch, got, want):
    """(values of the bf16 outputs that differ, values of bf16 outputs)."""
    pairs = [(k, p) for k, p in zip(got, want) if k.dtype == torch.bfloat16]
    return (sum(int((k != p).sum()) for k, p in pairs),
            sum(p.numel() for _, p in pairs))


def _excess(torch, got, want, ulps=0, carried=None, peak=None):
    """The largest amount by which ``got`` lies beyond ``want``'s bound:
    REL_TOL of the largest |value| in each row, plus ``ulps`` bf16 ulps of
    each value where ``got`` is bf16 (of its largest |value| over the
    steps, ``peak``, where given: a rounding flips at the value it had
    then), or where it is not ``ulps`` times the smaller of ``carried``
    (one ulp of each row's largest bf16 value) and one ulp of the row's own
    largest value.  At most 0 where ``got`` is within its bound."""
    g, w = _rows(got.float()), _rows(want.float())
    scale = w.abs().amax(1, keepdim=True)
    slack = REL_TOL * scale
    if ulps and got.dtype == torch.bfloat16:
        slack = slack + ulps * _ulp_bf16(
            torch, w if peak is None else _rows(peak))
    elif ulps and carried is not None and carried.shape[0] == w.shape[0]:
        slack = slack + ulps * torch.minimum(carried,
                                             _ulp_bf16(torch, scale))
    return float(((g - w).abs() - slack).max())


def _compare(torch, name, got, want, floor=None, what="kernel-plain",
             ulps=0, witness=0.0, peaks=None):
    """Max abs error over the outputs; raises beyond REL_TOL of a row's
    scale, or where a floor is given and is not below REL_TOL / 4.

    A bf16-state kernel over ``ulps`` steps (BF16_STEPS comment) may differ
    by ``ulps`` bf16 ulps of each bf16 value on top (of its largest |value|
    over the steps where ``peaks``, one per output or None, gives it), and
    its other outputs by ``ulps`` ulps of the row's largest bf16 value (at
    most of their own row's largest value); the share of its bf16 values
    that differ is held to BF16_WITNESS times ``witness`` (or
    BF16_FLOOR)."""
    peaks = peaks or [None] * len(want)
    carried = None
    for k, p, peak in zip(got, want, peaks):
        if ulps and k.dtype == torch.bfloat16:
            carried = _ulp_bf16(torch, _rows(
                (p if peak is None else peak).float()).abs().amax(
                    1, keepdim=True))
    worst = 0.0
    for label, k, p, peak in zip(name[1], got, want, peaks):
        if not torch.isfinite(k.float()).all() or (ulps and
                                                   k.dtype != p.dtype):
            raise AssertionError("{}: kernel output {} is {} or not "
                                 "finite".format(name[0], label, k.dtype))
        err = float((k.float() - p.float()).abs().max())
        rel = _rel_err(k.float(), p.float())
        print("  {} {}: max|{}| = {:.3e}, {:.3e} of its row's scale{}".format(
            name[0], label, what, err, rel,
            " (bf16)" if k.dtype == torch.bfloat16 else ""))
        over = _excess(torch, k, p, ulps, carried, peak)
        final = _excess(torch, k, p, ulps, carried)
        if peak is not None and final > 0:
            print("  {} {}: {:.3e} beyond the bound by the final values' "
                  "ulps, {:.3e} by their largest |value| over the "
                  "steps'".format(name[0], label, final, over))
        if not over <= 0:
            raise AssertionError("{}: {} disagrees ({}): {:.3e} beyond "
                                 "{:.1e} of its row's scale plus {} bf16 "
                                 "ulps".format(name[0], label, what, over,
                                               REL_TOL, ulps))
        worst = max(worst, err)
    flips, total = _bf16_flips(torch, got, want)
    if ulps and total:
        share, limit = flips / total, BF16_WITNESS * max(witness, BF16_FLOOR)
        print("  {}: {:.3e} of the bf16 values differ by an ulp or more "
              "(witness, plain on the card vs the CPU: {:.3e}; limit "
              "{:.3e})".format(name[0], share, witness, limit))
        if share > limit:
            raise AssertionError("{}: {:.3e} of the bf16 values differ, "
                                 "beyond {:.3e}".format(name[0], share,
                                                        limit))
    if floor is None:
        return worst
    print("  {}: floor (plain version from a 1e-7 nudge) {:.3e}".format(
        name[0], floor))
    if not floor < REL_TOL / 4:
        raise AssertionError(
            "{}: a 1e-7 nudge moves the plain version by {:.3e} of a row's "
            "scale: the check cannot tell rounding from disagreement".format(
                name[0], floor))
    return worst


def _ptxas_report(log_text, kernel="fused_kernel", instances=INSTANCES,
                  complete=True, tags=(" (device)", " (bf16)"), layouts=None):
    """``{kernel: "N registers, S bytes spill stores"}`` from ptxas -v;
    raises where ``complete`` and the log lacks a kernel of ``instances``
    (an older tree's log lacks the newer kernels).  ``layouts`` maps the
    slim kernels' trailing layout parameter to a suffix of the name."""
    out = {}
    k = len(next(iter(instances)))
    # the flags that follow, where the tree has them, name their
    # instantiations "... <tag>": the fused kernels' placement and
    # v-storage (kDevice, kVBf16), the slim kernels' bf16 operands (kMixed)
    # and then their layout (kLayout: B7 mask, B7')
    flags = (r"ILi(\d)E" + r"Lb(\d)E" * (k - 1)
             + r"(?:Lb(\d)E)?" * len(tags)
             + (r"(?:Li(\d)E)?" if layouts else ""))
    # (a kernel's other entries of the same body, e.g. fused_kernel_unhinted,
    # share its name and flags)
    pattern = re.compile(
        kernel + r"(?:_[a-z]+)?" + flags + r".*?\n\s*(\d+) bytes stack "
        r"frame, (\d+) bytes "
        r"spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
        re.S)
    for m in pattern.finditer(log_text):
        name = instances[tuple(int(m.group(i)) for i in range(1, k + 1))]
        j = k + len(tags)
        if layouts:
            j += 1
            name += layouts[int(m.group(j) or 0)]
        for i, tag in enumerate(tags):
            if m.group(k + 1 + i) == "1":
                name += tag
        out[name] = "{} registers, {} bytes spill stores, {} bytes spill " \
                    "loads".format(m.group(j + 4), m.group(j + 2),
                                   m.group(j + 3))
    if complete and not set(instances.values()) <= set(out):
        raise AssertionError("ptxas report lacks kernels: {}".format(
            sorted(set(instances.values()) - set(out))))
    return out


def _ptxas_svgd(log_text, complete=True):
    """``{"B11 ...": "N registers, ..."}`` of csrc/svgd_streaming.cu's
    kernels (the two pre-passes, and the transport with 16-byte and with
    4-byte copies, ``svgd_transport<4>`` and ``<1>``) from ptxas -v; raises
    where ``complete`` and one is missing (an older tree's transport is
    not a template)."""
    out = {}
    for kernel, name in ((r"svgd_transportILi4E", "B11"),
                         (r"svgd_transportILi1E", "B11 (4-byte copies)"),
                         ("squared_norms", "B11 norms pre-pass"),
                         ("fold_rhs", "B11 rhs pre-pass")):
        m = re.search(
            kernel + r".*?\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
            r"stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
            log_text, re.S)
        if m is None:
            if complete:
                raise AssertionError("ptxas report lacks {}".format(kernel))
            continue
        out[name] = "{} registers, {} bytes spill stores, {} bytes spill " \
                    "loads".format(m.group(4), m.group(2), m.group(3))
    return out


def _product_flops(lay, batch):
    """f32 operations of one chain-step's forward and backward products of
    ``_fwd_bwd`` (2 per multiply-add): the layers, the head, the weight
    gradients and the backward products."""
    b, h, k, d = batch, lay.hidden, lay.n_inputs, lay.depth
    fwd = 2 * b * k * h + (d - 1) * 2 * b * h * h + 2 * b * h
    bwd = 2 * b * h + (d - 1) * 2 * (2 * b * h * h) + 2 * b * k * h
    return fwd + bwd


def _noise_ops(lay, variant):
    """Operations of one chain-step's normals, one per parameter, from the
    fused kernels' generator ``variant`` (:func:`_variant_of`), counted
    from ``csrc/philox.cuh`` and ``csrc/fused_body.cuh``: Box-Muller (and
    the paired kernels) DRAW_OPS for each draw, one per four parameters
    (the last draw whole where P is not a multiple of 4); the CLT per
    group of n uniforms that holds values (the plain version's geometry,
    ``fused_step._clt_sections``) the n / 4
    Philox draws it needs (PHILOX_OPS each), 7 per uniform (its
    bits-to-uniform map 4, the - 1/2 and the bf16 rounding's two
    conversions), n log2 n adds of the Walsh-Hadamard transform, and one
    scaling multiply per value it hands on.  Its dead lanes count: the
    transform mixes them into every normal."""
    if variant != "hadamard_clt":
        return DRAW_OPS * -(-lay.n_params // 4)
    from pysgmcmc_tpu_torch.ops import fused_step as fs

    ops = 0
    for _, emap in fs._clt_sections(lay):
        rows, n = emap.shape
        live = int((emap >= 0).any(dim=1).sum())
        per_group = PHILOX_OPS * n // 4 + 7 * n + n * (n.bit_length() - 1)
        ops += live * per_group + int((emap >= 0).sum())
    return ops


def _tc_product_flops(lay, batch):
    """The part of :func:`_product_flops` that runs on the tensor cores:
    the hidden layers' forward products, weight gradients and backward
    products, 6 (depth - 1) batch H^2 (their biases ride along as one more
    row of each weight matrix and are not counted)."""
    return 6 * (lay.depth - 1) * batch * lay.hidden ** 2


def _flops_per_chain_step(lay, batch, rule_flops, variant="box_muller"):
    """(tensor-core flops, f32 operations) of one chain-step: the hidden
    layers' products (:func:`_tc_product_flops`) on the tensor cores; the
    rest of the products (layer 1's and the head's), the update rule's
    elementwise arithmetic on every parameter, and the normals of
    ``variant`` (:func:`_noise_ops`) on the CUDA cores.  tanh and the
    likelihood's exp are not counted."""
    tc = _tc_product_flops(lay, batch)
    return tc, (_product_flops(lay, batch) - tc
                + rule_flops * lay.n_params + _noise_ops(lay, variant))


def _variant_of(record):
    """The fused generator a record names (its tags, as :func:`_record`
    writes them): ``"hadamard_clt"``, ``"paired"`` or ``"box_muller"``."""
    words = set(re.split(r"[ (),]+", record))
    return ("hadamard_clt" if "clt" in words else
            "paired" if "paired" in words else "box_muller")


# elementwise f32 operations per parameter of each update rule, counted from
# the kernel source: prior fold 2; SGHMC noise scale 7 and momentum update 8,
# SGLD noise scale 5 (sampling) or 6 (burn-in) and increment 6; the mask 1
# (sampling) and the position add 1; burn-in adds the EMAs and minv, 30.
# pSGLD, relativistic SGHMC and SGNHT as the slim kernels' rules below
# (21, 24, 11), SGNHT plus 2 for its p'^T p'.
RULE_FLOPS = {"B1": 19, "B3": 19, "B2": 48, "B4-sgld": 15, "B5-sgld": 15,
              "B6": 45, "B4-psgld": 21, "B5-psgld": 21, "B4-rsghmc": 24,
              "B5-rsghmc": 24, "B4-sgnht": 13, "B5-sgnht": 13}
# The slim kernels apply the same rules without the mask, and draw every
# normal in the kernel.  A Box-Muller draw gives four normals: one
# Philox4x32-10 (10 rounds of 2 mulhi, 2 mul, 4 xor, and 2 key adds in 9 of
# them: 98), four bits-to-uniform maps (16) and, for each of its two pairs,
# a log, a root, a sine, a cosine and 4 multiplies (16): 130 operations, a
# quarter of them a normal (NOISE_OPS); the fused kernels draw theirs the
# same way (:func:`_noise_ops`).  All are counted against the f32 peak, an
# optimistic rate for the integer and special-function units, so the bound
# stays a lower bound.
# The rules without a mass matrix, counted the same way (per-chain constants
# not counted): pSGLD the prior fold 2, the accumulator 5, the preconditioner
# 4, the noise scale 4 and the update 6; RSGHMC the fold and its sign 3, two
# velocities of 7, the momentum 6 and the position add 1; SGNHT the fold 2,
# the momentum 7 and the position 2.
PHILOX_OPS = 98
DRAW_OPS = PHILOX_OPS + 16 + 16
NOISE_OPS = DRAW_OPS / 4
SLIM_OPS = {"B7": NOISE_OPS + 18, "B8-sgld": NOISE_OPS + 14,
            "B8-psgld": NOISE_OPS + 21, "B8-rsghmc": NOISE_OPS + 24,
            "B8-sgnht": NOISE_OPS + 11, "B9-sghmc": NOISE_OPS + 48,
            "B9-sgld": NOISE_OPS + 45}


def _bound(n_chains, steps, flops_per_chain_step, n_bytes):
    """(bound_ms, bound_by) of a fused launch: the larger of the bytes over
    HBM bandwidth and the operations' time, where ``flops_per_chain_step``
    is :func:`_flops_per_chain_step`'s pair.  The tensor-core flops count
    as 3xTF32 (three passes of split operands) at TF32_FLOPS and the f32
    operations at F32_FLOPS; the two pipes issue side by side, so the
    operations take the longer of the two."""
    tc, f32 = flops_per_chain_step
    compute_ms = n_chains * steps * max(
        3.0 * tc / TF32_FLOPS, f32 / F32_FLOPS) * 1e3
    memory_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    if compute_ms >= memory_ms:
        return compute_ms, "operations"
    return memory_ms, "bytes"


def _train_small(torch, x_np, y_np, method, config, start, device):
    """Train and predict the small BNN of ``config`` from the weights
    ``start`` through the port's entry points; returns the samples, one row
    of all parameters per sample, and the predictive mean."""
    import numpy as np

    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork

    bnn = BayesianNeuralNetwork(sampling_method=method, device=device,
                                **config)
    bnn._initial_positions = (
        lambda init_fn, generator, n: {k: v.to(device)
                                       for k, v in start.items()})
    bnn.train(x_np, y_np)
    samples = torch.cat([bnn.samples[k].reshape(len(bnn.samples[k]), -1)
                         for k in sorted(bnn.samples)], dim=1).cpu()
    mean = bnn.predict(np.linspace(0.0, 1.0, 50)[:, None])[0]
    return samples, torch.as_tensor(mean)


def _small_main_path(torch, x_np, y_np, method, config, check=True):
    """The small main path of ``config`` on the card (kernels) against the
    CPU (plain versions) from the same initial weights; returns the largest
    |card - CPU|.  With ``check=False`` only the CPU floor is measured and
    printed."""
    from pysgmcmc_tpu_torch.models import default_network, dense_network

    network = dense_network if config["network"] == "dense" \
        else default_network
    init_fn, _ = network(1, units=(H, H, H), device="cpu")
    start = init_fn(torch.Generator().manual_seed(7), (config["n_chains"],))
    cpu = _train_small(torch, x_np, y_np, method, config, start, "cpu")
    nudged = _train_small(torch, x_np, y_np, method, config,
                          {k: _nudge(torch, v) for k, v in start.items()},
                          "cpu")
    floor = max(_rel_err(a, b) for a, b in zip(nudged, cpu))
    label = "small {} {} main path ({} network, noise {}, eps {})".format(
        method.value, config["step_impl"], config["network"],
        config["noise_impl"], config.get("stepsize_schedule", EPS))
    if not check:
        print("  {}: not checked, floor {:.3e}".format(label, floor))
        return None
    card = _train_small(torch, x_np, y_np, method, config, start, "cuda")
    return _compare(torch, (label, ("samples", "predictive mean")), card,
                    cpu, floor, what="card-CPU")


def _run(fs, wrapper, one_step, state, x_win, y_win, eps, kw, k, stream,
         extra):
    """k steps of a kernel (or its plain version) from ``state``: one launch
    of a multi-step kernel, or k launches of a one-step kernel, each on the
    previous one's output with minv frozen.  Returns the last outputs."""
    injected = stream in ("injected", "zero")
    if not one_step:
        if injected:
            extra = dict(noise=extra["noise"][:k], widx=extra["widx"][:k])
        return wrapper(*state, x_win, y_win, eps, SEED, k_steps=k, **kw,
                       **extra)
    n = state[0].shape[0]
    cur = list(state)
    for t in range(k):
        if injected:
            widx, step_kw = extra["widx"][t], dict(noise=extra["noise"][t])
        else:
            step = extra["step0"] + t
            widx = fs.philox_windows(SEED, step, n, x_win.shape[0],
                                     state[0].device)
            step_kw = dict(step=step, **{key: extra[key] for key in
                                         ("noise_impl",) if key in extra})
        out = wrapper(*cur, *fs.gather_batch(x_win, y_win, widx), eps, SEED,
                      **kw, **step_kw)
        # the next step takes the new state and the frozen inputs (minv)
        cur = list(out[:-1]) + list(state[len(out) - 1:])
    return out


def _kernel_checks(torch, fs, checks, x_win, y_win, streams):
    """Every kernel against its plain version on the same inputs; returns
    ``{kernel: max abs error}``.  ``checks`` holds ``(name, kernel, plain
    version, state, keywords, output labels, one-step?, plan)`` with
    ``plan`` a list of ``(eps, steps, checked)`` over the injected and the
    Philox stream, or ``(eps, steps, checked, stream names)``; an unchecked
    entry only measures and prints the floor."""
    err = {}
    for name, fn, ref, state, kw, labels, one_step, plan in checks:
        err[name] = 0.0
        for eps, k, checked, *names in plan:
            names = names[0] if names else ("injected", "philox")
            for stream, extra in streams:
                if stream not in names:
                    continue
                def run(wrapper, start=state):
                    return _run(fs, wrapper, one_step, start, x_win, y_win,
                                eps, kw, k, stream, extra)

                want = run(ref)
                floor = max(_rel_err(a, b) for a, b in zip(
                    run(ref, (_nudge(torch, state[0]),) + state[1:]), want))
                tag = "{}/{}/eps {:g} x {}".format(name, stream, eps, k)
                if not checked:
                    print("  {}: not checked, floor {:.3e}".format(tag, floor))
                    continue
                got = run(fn)
                torch.cuda.synchronize()
                err[name] = max(err[name], _compare(torch, (tag, labels), got,
                                                    want, floor))
    return err


def _burned_in(torch, x, y, sampler_cls, n_chains, device, h=H,
               noise_impl="auto"):
    """A sampler and its states after BURNED_IN burn-in steps at EPS from
    He-normal weights of an ``h``-wide 3-layer network, through the port's
    burn-in driver (B2 / B6) with f32 state, its normals from
    ``noise_impl`` (by default the main path's, the CLT generator)."""
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.ops import fused_step as fs
    from pysgmcmc_tpu_torch.parallel import burnin_chain_fused

    init_fn, _ = dense_network(1, units=(h, h, h), device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    n_params = fs.FusedLayout(1, h, 3).n_params
    sampler = sampler_cls(lambda p, b: None, stepsize_schedule=EPS,
                          scale_grad=float(N_DATA),
                          gaussian_prior_scale=1.0 / (n_params * N_DATA))
    states = burnin_chain_fused(
        sampler, sampler.init(init_fn(gen, (n_chains,))), gen, BURNED_IN,
        x, y, state_dtype=torch.float32, noise_impl=noise_impl)
    return sampler, states


def _sampler(method, eps, cost_fn=None):
    """A sampler of the flagship's settings: ``scale_grad`` = N where the
    sampler has one, the folded weight prior's scale 1 / (P N)."""
    from pysgmcmc_tpu_torch.ops import fused_step as fs
    from pysgmcmc_tpu_torch.sampling import Sampler

    kw = dict(stepsize_schedule=eps,
              gaussian_prior_scale=1.0 / (fs.FusedLayout(1, H, 3).n_params
                                          * N_DATA))
    if method != "RelativisticSGHMC":
        kw["scale_grad"] = float(N_DATA)
    return Sampler.get_sampler(Sampler[method],
                               cost_fn=cost_fn or (lambda p, b: None), **kw)


def _packed_states(torch, sampler, st, n_chains):
    """The sampler's stacked state from a packed lanes check state (``theta``,
    ``v``, SGNHT's ``xi``) tiled to ``n_chains`` chains, BURNED_IN steps
    in."""
    from pysgmcmc_tpu_torch.ops import fused_step as fs

    lay = fs.FusedLayout(1, H, 3)
    reps = n_chains // st["theta"].shape[0]
    tiled = {k: v.repeat(reps, *(1,) * (v.ndim - 1)) for k, v in st.items()}
    states = sampler.init(fs.unpack(tiled["theta"], lay))
    fields = dict(step=torch.full((), BURNED_IN, dtype=torch.int64,
                                  device=tiled["theta"].device))
    if hasattr(states, "v"):
        fields["v"] = fs.unpack(tiled["v"], lay)
    else:
        fields["momentum"] = fs.unpack(tiled["v"], lay)
    if "xi" in tiled:
        fields["xi"] = tiled["xi"]
    return states._replace(**fields)


def _driver_check(torch, x, y, sampler, states, kernel, multi_kernel=None,
                  state_dtype=None, noise_impl="box_muller"):
    """The one-step driver (B3 / B4-* per step) against the multi-step
    driver (B1 / B5-*) from the same state and generator seed, with
    ``state_dtype`` state (float32 unless given); returns (worst error,
    launches of the one-step ``kernel`` in the multistep=False run,
    launches of ``multi_kernel`` in the multistep=True run), both of the
    generator ``noise_impl``'s instantiations."""
    from pysgmcmc_tpu_torch.parallel import sample_chain_fused

    device = states.step.device
    state_dtype = state_dtype or torch.float32
    variant = "clt" if noise_impl == "hadamard_clt" else ""
    runs, multi_launches = [], 0
    for multistep in (True, False):
        _zero_counts(kernel, *([multi_kernel] if multi_kernel else []))
        runs.append(sample_chain_fused(
            sampler, states, torch.Generator(device=device).manual_seed(5),
            DRIVER_SAMPLES, x, y, keep_every=DRIVER_KEEP,
            state_dtype=state_dtype, multistep=multistep,
            noise_impl=noise_impl))
        launches = _launches(kernel, variant)
        if multistep and multi_kernel is not None:
            multi_launches = _launches(multi_kernel, variant)
    torch.cuda.synchronize()
    label = "one-step driver ({}, {} state, {})".format(
        type(sampler).__name__, str(state_dtype).split(".")[1], noise_impl)
    keys = sorted(runs[0][1])
    worst = _compare(torch, (label, ["positions " + k for k in keys]),
                     [runs[1][1][k] for k in keys],
                     [runs[0][1][k] for k in keys],
                     what="one-step - multi-step")
    if int(runs[0][0].step) != int(runs[1][0].step):
        raise AssertionError("{}: step counters differ".format(label))
    return worst, launches, multi_launches


def _paired_drivers(torch, fs, x, y, init_fn, drivers, sghmc_sampler,
                    device):
    """The paired drivers (``pair_dots=True``, multi-step, Box-Muller) from
    the one-step driver checks' states: SGHMC's burn-in at bf16 state (B2
    paired), then each sampler's sampling driver at f32 state against the
    unpaired driver (bit for bit) and at bf16 state (the share of positions
    the once-per-launch rounding moves, printed); B3 paired, which no
    driver reaches, through its wrapper one step at a time on the Philox
    windows, at f32 state against B3.  Returns the paired launches by
    record."""
    from pysgmcmc_tpu_torch.parallel import (
        burnin_chain_fused,
        sample_chain_fused,
    )

    launches = {}
    _zero_counts(fs.fused_bnn_multistep_burnin)
    gen = torch.Generator(device=device).manual_seed(11)
    burned = burnin_chain_fused(
        sghmc_sampler, sghmc_sampler.init(init_fn(gen, (DRIVER_CHAINS,))),
        gen, BURNED_IN, x, y, pair_dots=True)
    launches["B2 (bf16, paired)"] = _launches(fs.fused_bnn_multistep_burnin,
                                              "paired")
    multi_of = {"B3": ("B1", fs.fused_bnn_multistep),
                "B4-sgld": ("B5-sgld", fs.fused_bnn_multistep_sgld),
                "B4-psgld": ("B5-psgld", fs.fused_bnn_multistep_psgld),
                "B4-sgnht": ("B5-sgnht", fs.fused_bnn_multistep_sgnht),
                "B4-rsghmc": ("B5-rsghmc", fs.fused_bnn_multistep_rsghmc)}
    for name, (multi_name, kernel) in multi_of.items():
        _, sampler, states = drivers[name]
        if name == "B3":
            states = burned
        dtypes = [torch.float32]
        if name in ("B3", "B4-sgnht", "B4-rsghmc"):
            dtypes.append(torch.bfloat16)
        for dtype in dtypes:
            runs = []
            for pair_dots in (False, True):
                _zero_counts(kernel)
                runs.append(sample_chain_fused(
                    sampler, states,
                    torch.Generator(device=device).manual_seed(5),
                    DRIVER_SAMPLES, x, y, keep_every=DRIVER_KEEP,
                    state_dtype=dtype, multistep=True, pair_dots=pair_dots,
                    noise_impl="box_muller")[1])
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            record = _record(multi_name + (" (bf16)" if bf16 else ""),
                             "paired")
            launches[record] = _launches(kernel, "paired")
            keys = sorted(runs[0])
            label = "paired driver ({}, {} state): {} chains x {} steps".format(
                type(sampler).__name__, "bf16" if bf16 else "f32",
                DRIVER_CHAINS, DRIVER_SAMPLES * DRIVER_KEEP)
            if not bf16:
                same = all(torch.equal(runs[0][k], runs[1][k]) for k in keys)
                print("{}: positions equal the unpaired driver's bit for bit: "
                      "{}; {} launches of {}".format(label, same,
                                                    launches[record], record))
                if not same:
                    raise AssertionError("{}: positions differ".format(label))
            else:
                moved = sum(int((runs[0][k] != runs[1][k]).sum())
                            for k in keys)
                total = sum(runs[0][k].numel() for k in keys)
                print("{}: {:.3e} of the positions differ from the unpaired "
                      "driver's (the rounding once per launch), {:.3e} of a "
                      "row's scale at most; {} launches of {}".format(
                          label, moved / total, max(
                              _rel_err(runs[1][k], runs[0][k])
                              for k in keys), launches[record], record))
    # B3 paired: the wrapper, step by step, as a caller would drive it
    x_win, y_win = fs.data_windows(x, y, BATCH)
    lay = fs.FusedLayout(1, H, 3)
    theta0 = fs.pack(burned.position, lay)
    minv = fs.pack(burned.stats.minv, lay)
    kw = dict(mdecay=sghmc_sampler.mdecay,
              scale_grad=sghmc_sampler.scale_grad,
              prior_scale=sghmc_sampler.gaussian_prior_scale,
              batch_size=BATCH, n_data=N_DATA)
    for dtype in (torch.float32, torch.bfloat16):
        ends = []
        for pair_dots in (False, True):
            _zero_counts(fs.fused_bnn_step)
            theta = theta0
            v = fs.pack(burned.momentum, lay).to(dtype)
            for step in range(DRIVER_KEEP):
                widx = fs.philox_windows(SEED, step, DRIVER_CHAINS,
                                         x_win.shape[0], device)
                theta, v, _ = fs.fused_bnn_step(
                    theta, v, minv.to(dtype), *fs.gather_batch(
                        x_win, y_win, widx), EPS, SEED, step=step,
                    state_dtype=dtype, pair_dots=pair_dots, **kw)
            ends.append((theta, v))
            if pair_dots:
                launches[_record("B3 (bf16)" if dtype == torch.bfloat16
                                 else "B3", "paired")] = \
                    _launches(fs.fused_bnn_step, "paired")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*ends))
        print("B3 paired ({} state): {} one-step launches, equal to B3's "
              "bit for bit: {}".format(str(dtype).split(".")[1], DRIVER_KEEP,
                                       same))
        if not same:
            raise AssertionError("B3 paired differs from B3")
    return launches


def _flagship(torch, x_np, y_np, sampling_method, kernels, card, rates,
              step_impl="fused", network="dense", expected=None,
              stepsize=None, chains=MAIN_CHAINS, burn_in=BURN_IN,
              sample_steps=SAMPLE_STEPS, gate=True, tag="", **bnn_kw):
    """Train + predict a flagship through the port's BNN (``chains``
    chains, ``burn_in`` + ``sample_steps`` steps, at the BNN's default
    stepsize unless ``stepsize`` is given, ``bnn_kw`` such as
    ``compute_dtype`` or ``units`` passed on) with every kernel count and
    the fused placement counts set to 0 just before; returns the launches
    (which must equal ``expected`` where given) and the BNN, and adds the
    phase rates to ``rates`` under ``tag``.  ``gate=False`` (a short run
    that only drives kernels) skips the MSE gate."""
    import numpy as np

    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork
    from pysgmcmc_tpu_torch.ops import fused_step as fs

    _zero_counts(*kernels.values())
    bnn = BayesianNeuralNetwork(
        sampling_method=sampling_method, network=network,
        step_impl=step_impl, n_chains=chains, n_nets=chains,
        burn_in_steps=burn_in, sample_steps=sample_steps,
        n_iters=burn_in + sample_steps,
        **({} if stepsize is None else dict(stepsize_schedule=stepsize)),
        **bnn_kw)
    t0 = time.perf_counter()
    bnn.train(x_np, y_np)
    train_s = time.perf_counter() - t0
    x_grid = np.linspace(0.0, 1.0, 200)[:, None]
    t0 = time.perf_counter()
    mean, var = bnn.predict(x_grid)
    predict_s = time.perf_counter() - t0
    launches = {name: _launches(fn, name) for name, fn in kernels.items()}
    label = "{} {} main path ({} network{}{})".format(
        sampling_method.value, step_impl, network,
        "" if stepsize is None else ", eps {:g}".format(stepsize),
        "".join(", {}={}".format(k, str(v).replace("torch.", ""))
                for k, v in sorted(bnn_kw.items())))
    mse = float(np.mean((mean - np.sinc(x_grid[:, 0] * 10 - 5)) ** 2))
    print("{}: {} chains, {} burn-in + {} sampling steps, {} samples; train "
          "{:.2f} s, predict {:.3f} s; launches {}; fused launches by "
          "placement {}".format(
              label, chains, burn_in, sample_steps,
              len(bnn.samples["w2"]), train_s, predict_s, launches,
              dict(fs.placements) or "none"))
    if not (np.isfinite(mean).all() and np.isfinite(var).all()):
        raise AssertionError("{}: predictions are not finite".format(label))
    if mean.shape != (200,) or var.shape != (200,):
        raise AssertionError("{}: prediction shapes {} {}".format(
            label, mean.shape, var.shape))
    if gate and not mse < 0.1:
        raise AssertionError("{}: predictive MSE {} >= 0.1".format(label, mse))
    if min(launches.values()) < 1:
        raise AssertionError("{}: a kernel was not launched: {}".format(
            label, launches))
    if expected is not None and launches != expected:
        raise AssertionError("{}: launches {}, want {}".format(
            label, launches, expected))
    print("{}: predictive MSE on sinc: {:.3e} ({})".format(
        label, mse, "gate 0.1" if gate else "a short run: not gated"))
    for phase, steps in (("burn_in", burn_in), ("sampling", sample_steps)):
        seconds = bnn.phase_seconds[phase]
        rates[(step_impl, sampling_method.value + tag, phase)] = \
            chains * steps / seconds
        print("{}: {} update-steps/s: {:.4e} ({} chains x {} steps in {:.3f} "
              "s; {})".format(label, phase, chains * steps / seconds,
                              chains, steps, seconds, card))
    rates[(step_impl, sampling_method.value + tag, "mse")] = mse
    return launches, bnn


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


# slim kernel -> (sampler of its check state, positional operands (None for
# the mask), output labels, stepsize)
SLIM = {
    "B7": ("SGHMC", ("theta", "v", "grad", "minv", None), ("theta", "v"),
           EPS),
    "B8-sgld": ("SGLD", ("theta", "grad", "minv", None), ("theta",),
                EPS_SGLD),
    "B8-psgld": ("PSGLD", ("theta", "v", "grad", None), ("theta", "v"),
                 B8_EPS["PSGLD"]),
    "B8-rsghmc": ("RelativisticSGHMC", ("theta", "v", "grad", None),
                  ("theta", "p"), B8_EPS["RelativisticSGHMC"]),
    "B8-sgnht": ("SGNHT", ("theta", "v", "grad", None, "xi"), ("theta", "p"),
                 B8_EPS["SGNHT"]),
    "B9-sghmc": ("SGHMC", ("theta", "v", "tau", "g", "v_hat", "grad", None),
                 ("theta", "v", "tau", "g", "v_hat", "minv"), EPS),
    "B9-sgld": ("SGLD", ("theta", "tau", "g", "v_hat", "grad", None),
                ("theta", "tau", "g", "v_hat", "minv"), EPS_SGLD),
}
# the sampler of each lanes flagship -> its burn-in and sampling kernels
LANES_FLAGSHIPS = (("SGHMC", "B9-sghmc", "B7"), ("SGLD", "B9-sgld", "B8-sgld"),
                   ("PSGLD", "B8-psgld", "B8-psgld"),
                   ("RelativisticSGHMC", "B8-rsghmc", "B8-rsghmc"),
                   ("SGNHT", "B8-sgnht", "B8-sgnht"))
# the fused kernels of the samplers without a mass matrix -> (sampler, state
# operands, output labels); the fused flagship of each burns in on the slim
# kernel of the same sampler
FUSED_NEW = {
    "B5-psgld": ("PSGLD", ("theta", "v"), ("theta", "v", "cost")),
    "B4-psgld": ("PSGLD", ("theta", "v"), ("theta", "v", "cost")),
    "B5-rsghmc": ("RelativisticSGHMC", ("theta", "v"), ("theta", "p", "cost")),
    "B4-rsghmc": ("RelativisticSGHMC", ("theta", "v"), ("theta", "p", "cost")),
    "B5-sgnht": ("SGNHT", ("theta", "v", "xi"), ("theta", "p", "xi", "cost")),
    "B4-sgnht": ("SGNHT", ("theta", "v", "xi"), ("theta", "p", "xi", "cost")),
}
SLIM_OF = {"PSGLD": "B8-psgld", "RelativisticSGHMC": "B8-rsghmc",
           "SGNHT": "B8-sgnht"}
# Their kernel checks, as the slim kernels' at each sampler's stepsize
# (B8_EPS), over CHECK_STEPS steps on injected noise and the Philox stream.
# pSGLD's preconditioner reaches 1 / lambda = 1e5 where a gradient is near
# 0; over CHECK_STEPS steps its floor stays near the others' (the script
# prints each), and its kernels are also checked on the degenerate stream
# (zero noise, window 0) at 1e-4, where its small main path runs.
FUSED_NEW_PLAN = {
    "PSGLD": [(B8_EPS["PSGLD"], CHECK_STEPS, True),
              (1e-4, CHECK_STEPS, True, ("zero",))],
    "RelativisticSGHMC": [(B8_EPS["RelativisticSGHMC"], CHECK_STEPS, True)],
    "SGNHT": [(B8_EPS["SGNHT"], CHECK_STEPS, True)],
}


def _fused_new_functions(fs):
    """fused kernel of FUSED_NEW -> (wrapper, plain version)."""
    return {"B5-psgld": (fs.fused_bnn_multistep_psgld,
                         fs.fused_bnn_multistep_psgld_ref),
            "B4-psgld": (fs.fused_bnn_step_psgld, fs.fused_bnn_step_psgld_ref),
            "B5-rsghmc": (fs.fused_bnn_multistep_rsghmc,
                          fs.fused_bnn_multistep_rsghmc_ref),
            "B4-rsghmc": (fs.fused_bnn_step_rsghmc,
                          fs.fused_bnn_step_rsghmc_ref),
            "B5-sgnht": (fs.fused_bnn_multistep_sgnht,
                         fs.fused_bnn_multistep_sgnht_ref),
            "B4-sgnht": (fs.fused_bnn_step_sgnht, fs.fused_bnn_step_sgnht_ref)}


def _slim_functions(su):
    """slim kernel -> (wrapper, plain version)."""
    return {"B7": (su.slim_sghmc_update, su.slim_sghmc_update_ref),
            "B8-sgld": (su.slim_sgld_update, su.slim_sgld_update_ref),
            "B8-psgld": (su.slim_psgld_update, su.slim_psgld_update_ref),
            "B8-rsghmc": (su.slim_rsghmc_update, su.slim_rsghmc_update_ref),
            "B8-sgnht": (su.slim_sgnht_update, su.slim_sgnht_update_ref),
            "B9-sghmc": (su.slim_sghmc_burnin_update,
                         su.slim_sghmc_burnin_update_ref),
            "B9-sgld": (su.slim_sgld_burnin_update,
                        su.slim_sgld_burnin_update_ref)}


def _slim_args(name, st):
    """The positional operands of slim kernel ``name`` from state ``st``."""
    return [None if k is None else st[k] for k in SLIM[name][1]]


def _lanes_check_states(torch, x, y):
    """The states of pSGLD, relativistic SGHMC and SGNHT after BURNED_IN
    steps of the lanes driver at CHECK_CHAINS chains on the CPU (plain
    versions), at their flagship stepsizes from He-normal weights, packed
    ``{"theta", "v" (accumulator or momentum), and for SGNHT "xi"}``."""
    from pysgmcmc_tpu_torch.models import (
        BayesianNeuralNetwork,
        default_network,
    )
    from pysgmcmc_tpu_torch.parallel import packed
    from pysgmcmc_tpu_torch.sampling import Sampler

    x, y = x.cpu(), y.cpu()
    init, apply = default_network(1, units=(H, H, H), device="cpu")
    out = {}
    for method, eps in B8_EPS.items():
        bnn = BayesianNeuralNetwork(
            sampling_method=Sampler[method], network="reference",
            step_impl="lanes", stepsize_schedule=eps, device="cpu")
        positions = init(torch.Generator().manual_seed(11), (CHECK_CHAINS,))
        keys = torch.Generator().manual_seed(11)
        sampler, burn, _ = bnn._lanes_path(apply, positions, x, y, N_DATA,
                                           keys)
        states = burn(sampler.init(positions, keys), BURNED_IN)
        spec = packed.make_lanes_spec({k: v[0] for k, v in
                                       states.position.items()})
        out[method] = {
            "theta": packed.pack_lanes(spec, states.position),
            "v": packed.pack_lanes(spec, states.v if method == "PSGLD"
                                   else states.momentum)}
        if method == "SGNHT":
            out[method]["xi"] = states.xi
    return out


def _slim_states(torch, fs, state, lay, x_win, y_win):
    """The burned-in check states tiled to the flagship's chains, each
    rule's with the gradient of its theta on the Philox windows of one step
    (the plain backward pass of the fused kernels, whose layout the
    reference network's lanes packing shares)."""
    n_chains = MAIN_CHAINS
    reps = n_chains // CHECK_CHAINS
    out = {}
    for rule, st in state.items():
        st = {k: v.repeat(reps, *(1,) * (v.ndim - 1))
              for k, v in st.items()}
        widx = fs.philox_windows(77, 0, n_chains, x_win.shape[0],
                                 st["theta"].device)
        xw = x_win[widx][:, :, None]
        st["grad"] = fs._fwd_bwd(st["theta"], lay, xw, y_win[widx],
                                 1.0 / BATCH, 1.0 / N_DATA)[1]
        out[rule] = st
    return out


def _slim_checks(torch, su, states, kws, bf16=False):
    """The seven slim kernels against their plain versions at the flagship
    shape, one step each, on injected noise, on the Philox stream and on the
    Philox stream with a per-chain eps row; returns ``{kernel: max abs
    error}``.  With f32 operands each beside its floor; with ``bf16`` the
    operands of SLIM_BF16 in bf16, each beside the witness (BF16_STEPS
    comment) of its first CHECK_CHAINS rows: the plain version on the card
    against the plain version on the CPU."""
    gen = torch.Generator(device=states["SGHMC"]["theta"].device)
    gen.manual_seed(4321)
    err = {}
    for name, (fn, ref) in _slim_functions(su).items():
        rule, operands, labels, eps = SLIM[name]
        args = _slim_args(name, states[rule])
        if bf16:
            args = [a.to(torch.bfloat16) if key in SLIM_BF16 else a
                    for key, a in zip(operands, args)]
        n = args[0].shape[0]
        streams = [
            ("injected", eps, dict(noise=torch.randn(
                args[0].shape, generator=gen, device=args[0].device))),
            ("philox", eps, dict(step=12345)),
            ("philox, per-chain eps", eps * (0.5 + torch.rand(
                n, generator=gen, device=args[0].device)), dict(step=12345)),
        ]
        tag = name + (" (bf16)" if bf16 else "")
        err[tag] = 0.0
        for stream, e, extra in streams:
            kw = dict(kws[rule], **extra)
            want = _tuple(ref(*args, e, SEED, **kw))
            got = _tuple(fn(*args, e, SEED, **kw))
            torch.cuda.synchronize()
            label = ("{}/{} x 1".format(tag, stream), labels)
            if bf16:
                flips, total = _bf16_flips(
                    torch, [w[:CHECK_CHAINS].cpu() for w in want],
                    _tuple(ref(*_head(torch, args, n), _head(torch, e, n),
                               SEED, **_head(torch, kw, n))))
                err[tag] = max(err[tag], _compare(
                    torch, label, got, want, ulps=1,
                    witness=flips / total if total else 0.0))
                continue
            floor = max(_rel_err(a, b) for a, b in zip(_tuple(ref(
                _nudge(torch, args[0]), *args[1:], e, SEED, **kw)), want))
            err[tag] = max(err[tag], _compare(torch, label, got, want,
                                              floor))
    return err


def _head(torch, x, n):
    """``x`` (a tensor, a list of operands or a dict of keywords) with each
    per-chain tensor (leading dimension ``n``) cut to its first
    CHECK_CHAINS rows, on the CPU."""
    if isinstance(x, dict):
        return {k: _head(torch, v, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_head(torch, v, n) for v in x]
    if torch.is_tensor(x) and x.ndim and x.shape[0] == n:
        return x[:CHECK_CHAINS].cpu()
    return x


def _fused_cost(torch, apply):
    """The fused path's cost of one chain (likelihood and log-variance
    prior; the weight prior is folded into the update), for autograd."""
    from pysgmcmc_tpu_torch.models import log_variance_prior_log_like

    def cost(params, batch):
        xb, yb = batch
        out = apply(params, xb)
        f_mean, f_log_var = out[:, 0:1], out[:, 1:2]
        mse = (yb - f_mean) ** 2
        ll = torch.sum(-mse * (0.5 / (torch.exp(f_log_var) + 1e-16))
                       - 0.5 * f_log_var) / BATCH
        return -(ll + log_variance_prior_log_like(f_log_var) / N_DATA)
    return cost


def _lanes_vs_fused(torch, x, y, sampler, states, eps):
    """The lanes drivers (autograd gradient, then the slim kernels) against
    the fused drivers on the dense network, from one state and one
    generator seed, on the Philox stream (Box-Muller, the lanes drivers'
    generator), over 16 steps: for SGHMC and SGLD
    8 burn-in (B9 against B2 / B6) and 8 sampling steps (B7 or B8-sgld
    against B1 / B5-sgld), for the samplers without burn-in two samples of 8
    steps (B8-* against B5-*).  ``sampler`` carries the fused path's cost.
    Returns the worst error."""
    from pysgmcmc_tpu_torch.data_batches import batch_fn
    from pysgmcmc_tpu_torch.ops import fused_step as fs
    from pysgmcmc_tpu_torch.parallel import (
        burnin_chain_fused,
        burnin_chain_lanes,
        sample_chain_fused,
        sample_chain_lanes,
    )

    device = states.step.device
    lay = fs.FusedLayout(1, H, 3)
    select = batch_fn(x, y, BATCH)
    burn_in = hasattr(states, "stats")
    if burn_in:
        drivers = {
            "fused": (lambda s, g: burnin_chain_fused(
                sampler, s, g, 8, x, y, state_dtype=torch.float32,
                noise_impl="box_muller"),
                      lambda s, g: sample_chain_fused(
                          sampler, s, g, 1, x, y, keep_every=8,
                          state_dtype=torch.float32, multistep=True,
                          noise_impl="box_muller")),
            "lanes": (lambda s, g: burnin_chain_lanes(
                sampler, s, g, 8, batch_fn=select, compute_dtype=None),
                      lambda s, g: sample_chain_lanes(
                          sampler, s, g, 1, batch_fn=select, keep_every=8,
                          compute_dtype=None)),
        }
        labels = ("positions after 8 burn-in steps",
                  "positions after 8 sampling steps")
    else:
        drivers = {
            "fused": (lambda s, g: s, lambda s, g: sample_chain_fused(
                sampler, s, g, 2, x, y, keep_every=8,
                state_dtype=torch.float32, multistep=True,
                noise_impl="box_muller")),
            "lanes": (lambda s, g: s, lambda s, g: sample_chain_lanes(
                sampler, s, g, 2, batch_fn=select, keep_every=8,
                compute_dtype=None)),
        }
        labels = ("positions after 8 steps", "positions after 16 steps")

    def run(path, start):
        gen = torch.Generator(device=device).manual_seed(5)
        burned = drivers[path][0](start, gen)
        _, pos, _ = drivers[path][1](burned, gen)
        samples = [fs.pack({k: v[:, i] for k, v in pos.items()}, lay)
                   for i in range(pos["w1"].shape[1])]
        return ([fs.pack(burned.position, lay)] if burn_in else []) + samples

    want = run("fused", states)
    nudged = run("fused", states._replace(position={
        k: _nudge(torch, v) for k, v in states.position.items()}))
    floor = max(_rel_err(a, b) for a, b in zip(nudged, want))
    got = run("lanes", states)
    torch.cuda.synchronize()
    return _compare(
        torch, ("lanes vs fused drivers ({}, dense, eps {:g})".format(
            type(sampler).__name__, eps), labels),
        got, want, floor, what="lanes - fused")


def _lanes_profile(torch, x, y, card):
    """One torch.profiler trace of PROFILED_STEPS lanes burn-in steps of the
    SGHMC flagship (8192 chains, reference network): how the step splits
    between the slim kernel and the rest (the autograd gradient, the packing
    and the minibatch gather), and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, default_network

    device = x.device
    bnn = BayesianNeuralNetwork(network="reference", step_impl="lanes",
                                n_chains=MAIN_CHAINS, n_nets=MAIN_CHAINS)
    init, apply = default_network(1, units=(H, H, H), device=device)
    positions = init(torch.Generator(device=device).manual_seed(3),
                     (MAIN_CHAINS,))
    sampler, burn, _ = bnn._lanes_path(apply, positions, x, y, N_DATA,
                                       torch.Generator().manual_seed(3))
    states = burn(sampler.init(positions), 5)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        burn(states, PROFILED_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    slim_us = other_us = 0.0
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        if "slim_kernel" in evt.name:
            slim_us += evt.time_range.elapsed_us()
        else:
            other_us += evt.time_range.elapsed_us()
    label = "lanes profile (SGHMC burn-in, {} chains, {} steps)".format(
        MAIN_CHAINS, PROFILED_STEPS)
    if not n_kernels:
        print("{}: the trace holds no device events; split and idle share "
              "not measured".format(label))
        return
    per = 1e-3 / PROFILED_STEPS
    busy = slim_us + other_us
    print("{}: wall {:.3f} ms/step (with the profiler on), device busy "
          "{:.3f} ms/step: slim kernel {:.3f} ms, gradient, packing and "
          "gather {:.3f} ms in {:.1f} device events/step; device idle "
          "{:.1%} ({})".format(
              label, wall_us * per, busy * per, slim_us * per,
              other_us * per, n_kernels / PROFILED_STEPS,
              max(0.0, 1.0 - busy / wall_us), card))
    _lanes_host_split(torch, x, y, sampler, burn, states, busy * per, label,
                      card)


def _lanes_host_split(torch, x, y, sampler, burn, states, busy_ms, label,
                      card):
    """The same steps on the host's clock, without the profiler: the whole
    step, the gradient pass (window draw included) and the window draw
    alone, each the least of HOST_ROUNDS timings of PROFILED_STEPS steps
    ending in a synchronize (one timing of each moves by tens of per cent
    on a shared host, enough to make the rest come out negative); the idle
    share is the trace's device busy time over this wall time."""
    from pysgmcmc_tpu_torch.data_batches import batch_fn
    from pysgmcmc_tpu_torch.parallel import packed

    select = batch_fn(x, y, BATCH)
    spec = packed.make_lanes_spec({k: v[0] for k, v in states.position.items()})
    theta = packed.pack_lanes(spec, states.position)

    def per_step(fn):
        def run():
            for step in range(PROFILED_STEPS):
                fn(step)
        return run

    runs = {"step": lambda: burn(states, PROFILED_STEPS),
            "grad": per_step(lambda s: packed._lanes_gradient(
                sampler, spec, theta, select, SEED, s)),
            "window": per_step(lambda s: select(SEED, s, theta.shape[0]))}
    ms = dict.fromkeys(runs, float("inf"))
    for _ in range(HOST_ROUNDS):  # interleaved, so drift hits all three
        for key, run in runs.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms[key] = min(ms[key], (time.perf_counter() - start) * 1e3
                          / PROFILED_STEPS)
    rest = ms["step"] - ms["grad"]
    print("{}, host clock without the profiler (least of {}): {:.3f} "
          "ms/step, of which the gradient pass {:.3f} ms (its window draw and "
          "gather {:.3f} ms) and the slim launch, packing and the rest {}; "
          "device idle {:.1%} ({})".format(
              label, HOST_ROUNDS, ms["step"], ms["grad"], ms["window"],
              "{:.3f} ms".format(rest) if rest >= 0 else
              "not resolved (below the host clock's spread)",
              max(0.0, 1.0 - busy_ms / ms["step"]), card))


def _svgd_bnn(n_iters, n_nets=SVGD_PARTICLES, kernel_impl="streaming"):
    """The SVGD flagship's BNN (streaming kernel, reference network), with
    ``n_iters`` steps of ``n_nets`` particles."""
    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork
    from pysgmcmc_tpu_torch.sampling import Sampler

    return BayesianNeuralNetwork(
        sampling_method=Sampler.SVGD, kernel_impl=kernel_impl, n_nets=n_nets,
        n_iters=n_iters, batch_size=BATCH, network="reference",
        units=(H, H, H), device="cuda")


def _svgd_state(torch, x_np, y_np, x, y):
    """The flagship's ensemble after SVGD_STATE_STEPS steps on the card and
    every particle's cost gradient on the first window, flat ``(n, d)``,
    with the median bandwidth of the ensemble."""
    from pysgmcmc_tpu_torch.ops import pairwise
    from pysgmcmc_tpu_torch.samplers.svgd import _ravel_particles

    bnn = _svgd_bnn(SVGD_STATE_STEPS)
    bnn.train(x_np, y_np)

    def cost(params, batch):
        return bnn.negative_log_likelihood(bnn._apply_fn, params, batch[0],
                                           batch[1], N_DATA)[0]

    grads, _ = torch.func.vmap(torch.func.grad_and_value(cost),
                               in_dims=(0, None))(
        bnn.samples, (x[:BATCH], y[:BATCH, None]))
    flat_x = _ravel_particles(bnn.samples)[0]
    n = flat_x.shape[0]
    return (flat_x, _ravel_particles(grads)[0], pairwise.median_bandwidth(
        pairwise.squared_distance_matrix(flat_x), n))


def _svgd_bound(n, d):
    """(bound_ms, bound_by) of one B11 call: the symmetric Gram matrix (n^2
    d f32 operations) and one n x n x d product K (-G - X / h^2) (2 n^2 d;
    the n^2 exponentials not counted), against x and g read and phi written
    once.  B11's time is set against this f32 bound; :func:`_svgd_tf32_bound`
    stands beside it."""
    compute_ms = 3.0 * n * n * d / F32_FLOPS * 1e3
    memory_ms = 3.0 * 4 * n * d / HBM_BYTES_PER_S * 1e3
    if compute_ms >= memory_ms:
        return compute_ms, "operations"
    return memory_ms, "bytes"


def _svgd_tf32_bound(n, d):
    """ms of the function's work at f32 accuracy on the tensor cores: the
    symmetric Gram (n^2 d) and K V (2 n^2 d), each as three TF32 passes
    (3xTF32), at the TF32 peak.  (B11 computes the whole Gram, 4 n^2 d in
    all: its own work is 4/3 of this.)"""
    return 3.0 * 3.0 * n * n * d / TF32_FLOPS * 1e3


def _svgd_checks(torch, ss, cases):
    """B11 against its plain version on each ``(label, x, g, h)``: per
    particle row within REL_TOL, beside the plain version's floor (from a
    1e-7 nudge of x); two launches must agree bit for bit.  Returns the
    worst max abs error."""
    worst = 0.0
    for label, x, g, h in cases:
        want = ss.svgd_phi_streaming_ref(x, g, h)
        floor = _rel_err(ss.svgd_phi_streaming_ref(_nudge(torch, x), g, h),
                         want)
        got = ss.svgd_phi_streaming(x, g, h)
        again = ss.svgd_phi_streaming(x, g, h)
        torch.cuda.synchronize()
        tag = "B11 {} ({} x {})".format(label, *x.shape)
        if not torch.equal(got, again):
            raise AssertionError("{}: two launches differ".format(tag))
        worst = max(worst, _compare(torch, (tag, ("phi",)), (got,), (want,),
                                    floor))
    return worst


def _svgd_times(torch, ss, x, g, h, card):
    """Device ms at the flagship's shape: B11 (median of SVGD_TIMED), its
    plain version, the dense path for the same phi (JAX's
    ``kernel_impl="dense"``: ``svgd_kernel`` and a product, three cuBLAS
    calls with its own bandwidth) and the median bandwidth alone (median
    of 5 each).  Returns ``{name: ms}`` and B11's bound."""
    from pysgmcmc_tpu_torch.ops import _build, pairwise

    n, d = x.shape

    def dense():
        kernel, grad_kernel = pairwise.svgd_kernel(x)
        return (torch.matmul(kernel, -g) + grad_kernel) / n

    runs = {"B11": (lambda: ss.svgd_phi_streaming(x, g, h), SVGD_TIMED),
            "B11 plain": (lambda: ss.svgd_phi_streaming_ref(x, g, h), 5),
            "B11 dense": (dense, 5),
            "B11 bandwidth": (lambda: pairwise.median_bandwidth(
                pairwise.squared_distance_matrix(x), n), 5)}
    ms = {}
    for name, (fn, repeats) in runs.items():
        fn()  # warm-up
        ms[name] = _median_ms(torch, fn, repeats)
    bound = _svgd_bound(n, d)
    lib = _build.load("svgd_streaming")
    print("time B11 at {} particles x {} parameters: kernel {:.3f} ms (median "
          "of {}), plain {:.3f} ms, dense path (svgd_kernel + matmul, three "
          "cuBLAS calls) {:.3f} ms, median bandwidth {:.3f} ms (medians of "
          "5), bound {:.3f} ms ({}, f32), tensor-core bound of the "
          "function's work as 3xTF32 {:.3f} ms; {} bytes of shared memory "
          "a block, {} clusters "
          "of 2 resident ({})".format(
              n, d, ms["B11"], SVGD_TIMED, ms["B11 plain"], ms["B11 dense"],
              ms["B11 bandwidth"], bound[0], bound[1], _svgd_tf32_bound(n, d),
              lib.svgd_streaming_smem_bytes(),
              lib.svgd_streaming_active_clusters(), card))
    print("time B11 / dense path: {:.3f}".format(ms["B11"] / ms["B11 dense"]))
    return ms, bound


class _PlainTransport:
    """Within the block the SVGD sampler's transport is B11's plain
    version (on the card too); on leaving, B11 is back and its launch count
    must not have moved, so the swap is known to have taken effect."""

    def __init__(self, ss):
        import pysgmcmc_tpu_torch.samplers.svgd as svgd_module

        self.ss, self.module = ss, svgd_module

    def __enter__(self):
        ss = self.ss

        def plain(x, g, h, tile=512, interpret=False):
            return ss.svgd_phi_streaming_ref(x, g, h, tile)

        self.launches = ss.svgd_phi_streaming.launches
        self.module.svgd_phi_streaming = plain

    def __exit__(self, *exc):
        self.module.svgd_phi_streaming = self.ss.svgd_phi_streaming
        if exc[0] is None and \
                self.ss.svgd_phi_streaming.launches != self.launches:
            raise AssertionError("the plain transport run launched B11")


def _launched(ss, n_steps, fn):
    """``fn()``, which must launch B11 ``n_steps`` times."""
    before = ss.svgd_phi_streaming.launches
    out = fn()
    if ss.svgd_phi_streaming.launches - before != n_steps:
        raise AssertionError("{} launches of B11, want {}".format(
            ss.svgd_phi_streaming.launches - before, n_steps))
    return out


def _svgd_small(torch, x_np, y_np, ss):
    """The small SVGD main path (SVGD_SMALL particles, SVGD_SMALL_STEPS
    steps, streaming) on the card (B11) against the CPU (plain version) from
    the same particles and Philox windows: the predictive mean and the
    samples, each beside its floor.  The samples amplify rounding (Adagrad's
    1 / sqrt(hist) turns a rounding-sized change of a phi near 0 into a
    step of order eps), so the same path also runs on the card with the
    plain phi (cuBLAS) and with the dense path: their distances from the
    CPU are the witnesses of how far rounding alone carries the samples,
    and B11's distance is also held to SVGD_WITNESS times the larger.
    """
    from pysgmcmc_tpu_torch.models import default_network
    from pysgmcmc_tpu_torch.sampling import Sampler

    init_fn, _ = default_network(1, units=(H, H, H), device="cpu")
    start = init_fn(torch.Generator().manual_seed(7), (SVGD_SMALL,))
    config = dict(kernel_impl="streaming", n_nets=SVGD_SMALL,
                  n_iters=SVGD_SMALL_STEPS, batch_size=BATCH,
                  network="reference")

    def run(device, begin=start, **change):
        return _train_small(torch, x_np, y_np, Sampler.SVGD,
                            dict(config, **change), begin, device)

    cpu = run("cpu")
    nudged = run("cpu", {k: _nudge(torch, v) for k, v in start.items()})
    card = _launched(ss, SVGD_SMALL_STEPS, lambda: run("cuda"))
    with _PlainTransport(ss):
        card_plain = run("cuda")
    card_dense = run("cuda", kernel_impl="dense")
    label = "small SVGD main path ({} particles, {} steps, streaming)".format(
        SVGD_SMALL, SVGD_SMALL_STEPS)
    for i, what in ((1, "predictive mean"), (0, "samples")):
        _compare(torch, (label, (what,)), card[i:i + 1], cpu[i:i + 1],
                 _rel_err(nudged[i], cpu[i]), what="card-CPU")
    readings = {"B11": _rel_err(card[0], cpu[0]),
                "plain phi": _rel_err(card_plain[0], cpu[0]),
                "dense path": _rel_err(card_dense[0], cpu[0])}
    limit = SVGD_WITNESS * max(readings["plain phi"], readings["dense path"])
    print("{} samples, max|card-CPU| of a particle's scale: {} (B11 vs the "
          "plain phi, both on the card, {:.3e}); limit {} x the larger "
          "witness = {:.3e}".format(
              label, ", ".join("{} {:.3e}".format(k, v)
                               for k, v in readings.items()),
              _rel_err(card[0], card_plain[0]), SVGD_WITNESS, limit))
    if not readings["B11"] <= limit:
        raise AssertionError(
            "{}: B11's samples are {:.3e} of a particle's scale from the "
            "CPU's, beyond {} x the rounding witnesses".format(
                label, readings["B11"], SVGD_WITNESS))


def _svgd_plain_vs_kernel(torch, x_np, y_np, ss):
    """The flagship's first SVGD_TWICE_STEPS steps at full size on B11, on
    its plain version on the card (the sampler's transport swapped for
    that run) and on the dense path: per leaf, the distance of B11's and
    of the dense path's samples from the plain phi's, as a share of the
    leaf's scale; B11's is held to SVGD_WITNESS times the dense path's
    (the witness of rounding) or REL_TOL, whichever is larger."""
    def train(**kw):
        bnn = _svgd_bnn(SVGD_TWICE_STEPS, **kw)
        bnn.train(x_np, y_np)
        return bnn.samples

    kernel = _launched(ss, SVGD_TWICE_STEPS, train)
    with _PlainTransport(ss):
        plain = train()
    dense = train(kernel_impl="dense")

    def shares(samples):
        return {k: float((samples[k] - plain[k]).abs().max()
                         / plain[k].abs().max()) for k in plain}

    got, witness = shares(kernel), shares(dense)
    for what, values in (("B11", got), ("dense path", witness)):
        print("SVGD flagship, first {} steps on the {} vs on the plain phi: "
              "max|diff| / max|leaf| {}".format(
                  SVGD_TWICE_STEPS, what, ", ".join(
                      "{} {:.3e}".format(k, v)
                      for k, v in sorted(values.items()))))
    for k in got:
        limit = max(REL_TOL, SVGD_WITNESS * witness[k])
        if not got[k] <= limit:
            raise AssertionError(
                "SVGD flagship, first {} steps: B11's {} is {:.3e} of its "
                "scale from the plain phi's, beyond {:.3e}".format(
                    SVGD_TWICE_STEPS, k, got[k], limit))


def _svgd_flagship(torch, x_np, y_np, ss, card):
    """Train + predict the SVGD flagship through the port's BNN with B11's
    count set to 0 just before; returns B11's launches (SVGD_STEPS, one a
    step)."""
    import numpy as np

    ss.svgd_phi_streaming.launches = 0
    bnn = _svgd_bnn(SVGD_STEPS)
    t0 = time.perf_counter()
    bnn.train(x_np, y_np)
    train_s = time.perf_counter() - t0
    launches = ss.svgd_phi_streaming.launches
    x_grid = np.linspace(0.0, 1.0, 200)[:, None]
    t0 = time.perf_counter()
    mean, var = bnn.predict(x_grid)
    predict_s = time.perf_counter() - t0
    members = bnn.predict(x_grid, return_individual_predictions=True)[0]
    label = "SVGD main path (reference network, streaming, B11)"
    mse = float(np.mean((mean - np.sinc(x_grid[:, 0] * 10 - 5)) ** 2))
    spread = float(np.std(members, axis=0).mean())
    seconds = bnn.phase_seconds["transport"]
    print("{}: {} particles x {} steps; train {:.2f} s (transport {:.3f} s), "
          "predict {:.3f} s; {} launches of B11".format(
              label, SVGD_PARTICLES, SVGD_STEPS, train_s, seconds, predict_s,
              launches))
    if not (np.isfinite(mean).all() and np.isfinite(var).all()):
        raise AssertionError("{}: predictions are not finite".format(label))
    if mean.shape != (200,) or members.shape != (SVGD_PARTICLES, 200):
        raise AssertionError("{}: prediction shapes {} {}".format(
            label, mean.shape, members.shape))
    if launches != SVGD_STEPS:
        raise AssertionError("{}: {} launches of B11, want {}".format(
            label, launches, SVGD_STEPS))
    if not mse < 0.1:
        raise AssertionError("{}: predictive MSE {} >= 0.1".format(label, mse))
    if not spread > 1e-6:
        raise AssertionError("{}: the members collapsed (spread {})".format(
            label, spread))
    print("{}: predictive MSE on sinc {:.3e} (gate 0.1), mean member spread "
          "{:.3e} (gate 1e-6)".format(label, mse, spread))
    print("{}: particle-steps/s {:.4e} ({} particles x {} steps in {:.3f} s; "
          "{})".format(label, SVGD_PARTICLES * SVGD_STEPS / seconds,
                       SVGD_PARTICLES, SVGD_STEPS, seconds, card))
    return launches


# bf16 instantiations of the fused kernels -> (kernel name in FUSED_NEW or
# the SGHMC / SGLD checks, rule of its check state, state operands, which of
# them bf16, one-step?)
FUSED_BF16 = {
    "B1": ("SGHMC", ("theta", "v", "minv"), ("v", "minv"), False),
    "B2": ("SGHMC", ("theta", "v", "tau", "g", "v_hat"), ("v",), False),
    "B3": ("SGHMC", ("theta", "v", "minv"), ("v", "minv"), True),
    "B4-sgld": ("SGLD", ("theta", "minv"), ("minv",), True),
    "B5-sgld": ("SGLD", ("theta", "minv"), ("minv",), False),
    "B4-psgld": ("PSGLD", ("theta", "v"), ("v",), True),
    "B4-sgnht": ("SGNHT", ("theta", "v", "xi"), ("v",), True),
    "B4-rsghmc": ("RelativisticSGHMC", ("theta", "v"), ("v",), True),
    "B5-sgnht": ("SGNHT", ("theta", "v", "xi"), ("v",), False),
    "B5-rsghmc": ("RelativisticSGHMC", ("theta", "v"), ("v",), False),
}
# the slim kernels' bf16 operands (the lanes path under compute_dtype and
# bf16 state): the gradient always, v and minv where the kernel has them
SLIM_BF16 = ("v", "minv", "grad")

# ---- the MXU-CLT generator (B-CLT) and the paired kernels (B-pair) ----
# Each fused kernel has a CLT instantiation (noise_impl="hadamard_clt", the
# fused drivers' default) and B1, B2, B3, B5-* and B6 a paired one
# (pair_dots=True: Box-Muller, the matrix slabs' bf16 momentum rounded once
# per launch).  Their records are named as the Box-Muller kernels' with a
# "clt" or "paired" tag, and are timed over VARIANT_STEPS steps a launch,
# kernel and plain version alike (kernel_times.py times them over
# SAMPLE_STEPS beside the Box-Muller kernels).
VARIANT_STEPS = 20
VARIANT_KW = {"": {}, "clt": dict(noise_impl="hadamard_clt"),
              "paired": dict(pair_dots=True)}
PAIRED_KERNELS = ("B1", "B2", "B3", "B5-sgld", "B6", "B5-psgld", "B5-sgnht",
                  "B5-rsghmc")
# the TPU code each variant replaces in pysgmcmc_tpu/ops/fused_step.py: the
# CLT generator _normal_clt (with _hadamard_pm1 and _block_etas' geometry),
# and the paired kernels' generators
CLT_LINE = 111
PAIRED_LINES = {"B1": 1690, "B5-sgld": 1690, "B5-psgld": 1690,
                "B5-sgnht": 1690, "B5-rsghmc": 1690, "B2": 2636, "B6": 2636,
                "B3": 427}


def _record(name, *tags):
    """The record of a kernel variant: ``_record("B1 (bf16)", "clt")`` is
    ``"B1 (bf16, clt)"``."""
    base, _, rest = name.partition(" ")
    tags = ([rest[1:-1]] if rest else []) + [t for t in tags if t]
    return base + (" ({})".format(", ".join(tags)) if tags else "")


def _zero_counts(*fns):
    """Sets the launch counts of the wrappers ``fns`` to 0, and those of
    the fused kernels' variants (``fs.placements``)."""
    from pysgmcmc_tpu_torch.ops import fused_step as fs

    for fn in fns:
        fn.launches = 0
    fs.placements.clear()


def _launches(fn, record):
    """The launches of wrapper ``fn`` since :func:`_zero_counts`: a fused
    wrapper's of the variant ``record`` names (its tags, as
    :func:`_record` writes them, or the tag itself: ``"clt"``,
    ``"paired"``, else Box-Muller) from ``fs.placements``, another's
    ``fn.launches``."""
    from pysgmcmc_tpu_torch.ops import fused_step as fs

    if fn.__module__ != fs.__name__:
        return fn.launches
    return fs.variant_launches(fn, _variant_of(record))


# ---- FusedSGHMC (B10) and the packed (B7 mask) and stacked (B7') drivers:
# SGHMC over the reference network's full cost (weight and log-variance
# priors in the cost: B10 folds no prior, and these samplers fold none) ----
FLAT_SEED = 21
# elementwise f32 operations per element, counted as SLIM_OPS: B10 is
# B9-sghmc without the prior fold (48 - 2), B7 mask B7 with the mask's
# multiply (18 + 1), B7' B7 (its bf16 copy a conversion, not counted)
FLAT_OPS = {"B10": NOISE_OPS + 46, "B7-mask": NOISE_OPS + 19,
            "B7'": NOISE_OPS + 18}


def _reference_cost(torch, apply_fn, device):
    """The reference BNN's full cost of one chain on a minibatch, the lanes
    path's (``BayesianNeuralNetwork.negative_log_likelihood``)."""
    from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork

    bnn = BayesianNeuralNetwork(batch_size=BATCH, step_impl="lanes",
                                device=device)

    def cost(params, batch):
        return bnn.negative_log_likelihood(apply_fn, params, *batch,
                                           N_DATA)[0]
    return cost


def _ensemble_mse(torch, x_np, y_np, apply_fn, positions):
    """The sinc MSE of the ensemble mean of ``positions`` (stacked leaves)
    at 200 grid points, in the data's units (inputs and outputs normalized
    as ``_data`` normalizes the training data)."""
    import numpy as np

    grid = np.linspace(0.0, 1.0, 200)[:, None]
    device = next(iter(positions.values())).device
    xg = torch.as_tensor((grid - x_np.mean(axis=0)) / x_np.std(axis=0),
                         dtype=torch.float32, device=device)
    with torch.no_grad():
        f_mean = apply_fn({k: v.float() for k, v in positions.items()},
                          xg)[..., 0]
    mean = f_mean.mean(0).cpu().numpy() * y_np.std() + y_np.mean()
    if not np.isfinite(mean).all():
        raise AssertionError("the ensemble's predictions are not finite")
    return float(np.mean((mean - np.sinc(grid[:, 0] * 10 - 5)) ** 2))


def _fused_sghmc_flagship(torch, x_np, y_np, x, y, card, rates):
    """FusedSGHMC at MAIN_CHAINS chains of the reference network: BURN_IN +
    SAMPLE_STEPS steps through ``run`` with per-chain windows, one B10
    launch a step, B10's count set to 0 just before; gated on the sinc MSE
    of the final positions' ensemble mean.  Returns ``(sampler, final
    state, apply_fn, cost, window selector, launches, the network's leaf
    order)``."""
    from pysgmcmc_tpu_torch.data_batches import batch_fn
    from pysgmcmc_tpu_torch.models import default_network
    from pysgmcmc_tpu_torch.ops import fused_update as fu
    from pysgmcmc_tpu_torch.samplers import FusedSGHMC

    device = x.device
    init_fn, apply_fn = default_network(1, units=(H, H, H), device=device)
    positions = init_fn(torch.Generator(device=device).manual_seed(
        FLAT_SEED), (MAIN_CHAINS,))
    cost = _reference_cost(torch, apply_fn, device)
    fused = FusedSGHMC(cost, {k: v[0] for k, v in positions.items()},
                       stepsize=EPS, burn_in_steps=BURN_IN,
                       scale_grad=float(N_DATA), seed=SEED)
    select = batch_fn(x, y, BATCH)
    gen = torch.Generator(device=device).manual_seed(FLAT_SEED)
    state = fused.init(positions)
    fu.fused_sghmc_update.launches = 0
    seconds = {}
    for phase, steps in (("burn_in", BURN_IN), ("sampling", SAMPLE_STEPS)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, costs = fused.run(state, gen, steps, batch_fn=select)
        torch.cuda.synchronize()
        seconds[phase] = time.perf_counter() - start
    launches = fu.fused_sghmc_update.launches
    label = "FusedSGHMC main path (reference network, eps {:g})".format(EPS)
    mse = _ensemble_mse(torch, x_np, y_np, apply_fn,
                        fused.unflatten_positions(state.theta))
    dim = fused.dim
    padding_finite = all(bool(torch.isfinite(getattr(state, f)[:, dim:]).all())
                         for f in ("theta", "momentum", "tau", "g", "v_hat",
                                   "minv"))
    print("{}: {} chains x {} parameters ({} columns), {} burn-in + {} "
          "sampling steps; launches of B10 {}; costs finite: {}; padding "
          "columns finite (never read): {}; predictive MSE on sinc {:.3e} "
          "(gate 0.1)".format(
              label, MAIN_CHAINS, dim, fused.dim_padded, BURN_IN,
              SAMPLE_STEPS, launches, bool(torch.isfinite(costs).all()),
              padding_finite, mse))
    for phase, steps in (("burn_in", BURN_IN), ("sampling", SAMPLE_STEPS)):
        rates[("flat", "FusedSGHMC", phase)] = MAIN_CHAINS * steps / seconds[
            phase]
        print("{}: {} update-steps/s: {:.4e} ({} chains x {} steps in {:.3f} "
              "s; {})".format(label, phase, rates[("flat", "FusedSGHMC",
                                                   phase)],
                              MAIN_CHAINS, steps, seconds[phase], card))
    if launches != BURN_IN + SAMPLE_STEPS:
        raise AssertionError("{}: {} launches of B10, want {}".format(
            label, launches, BURN_IN + SAMPLE_STEPS))
    if not (mse < 0.1 and torch.isfinite(costs).all()):
        raise AssertionError("{}: predictive MSE {} (gate 0.1)".format(
            label, mse))
    return fused, state, apply_fn, cost, select, launches, tuple(positions)


def _sghmc_states(torch, fused, state, order):
    """FusedSGHMC's flat state as a stacked SGHMCState, leaves in
    ``order`` (the network's), its step counter a device tensor."""
    from pysgmcmc_tpu_torch.samplers import AdaptiveStats, SGHMCState

    def tree(flat):
        leaves = fused.unflatten_positions(flat)
        return {k: leaves[k].contiguous() for k in order}

    return SGHMCState(
        position=tree(state.theta), momentum=tree(state.momentum),
        stats=AdaptiveStats(*(tree(getattr(state, f))
                              for f in ("tau", "g", "v_hat", "minv"))),
        step=torch.tensor(state.step, device=state.theta.device),
        schedule_state=())


def _flat_driver_flagship(torch, x_np, y_np, name, fn, kernel, sampler,
                          states, select, apply_fn, card, rates, **kw):
    """SAMPLE_STEPS steps of ``fn`` (sample_chain_packed or
    sample_chain_stacked) from the burned-in ``states``, the kernel's count
    set to 0 just before; gated on the sinc MSE.  The packed driver's last
    launch is recorded to check that the slot padding of theta and v is
    exactly 0 at the end.  Returns the launches."""
    from pysgmcmc_tpu_torch.parallel import packed

    real, last = packed.slim_sghmc_update, []

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        last[:] = [out, args[4]]
        return out

    packed.slim_sghmc_update = recording
    kernel.launches = 0
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        out, _, costs = fn(sampler, states, torch.Generator(
            device=states.step.device).manual_seed(FLAT_SEED), 1,
            batch_fn=select, keep_every=SAMPLE_STEPS,
            collect_positions=False, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        packed.slim_sghmc_update = real
    launches = kernel.launches
    mse = _ensemble_mse(torch, x_np, y_np, apply_fn, out.position)
    rate = MAIN_CHAINS * SAMPLE_STEPS / seconds
    rates[("flat", name, "sampling")] = rate
    rates[("flat", name, "mse")] = mse
    label = "{} main path ({})".format(name, ", ".join(
        "{}={}".format(k, str(v).replace("torch.", ""))
        for k, v in sorted(kw.items())) or "defaults")
    padding = ""
    if last:
        pad = last[1][0] == 0
        zero = not (last[0][0][:, pad].any() or last[0][1][:, pad].any())
        padding = "; padding columns of theta and v exactly 0: {}".format(
            zero)
        if not zero:
            raise AssertionError("{}: the slot padding moved".format(label))
    print("{}: {} chains, {} sampling steps from the FusedSGHMC state; "
          "launches {}; predictive MSE on sinc {:.3e} (gate 0.1){}; "
          "update-steps/s {:.4e} ({:.3f} s; {})".format(
              label, MAIN_CHAINS, SAMPLE_STEPS, launches, mse, padding, rate,
              seconds, card))
    if launches != SAMPLE_STEPS:
        raise AssertionError("{}: {} launches, want {}".format(
            label, launches, SAMPLE_STEPS))
    if not (mse < 0.1 and torch.isfinite(costs).all()):
        raise AssertionError("{}: predictive MSE {} (gate 0.1)".format(
            label, mse))
    return launches


def _flat_checks(torch, fused, state, sampler, states, select, card):
    """B10, B7 mask and B7' against their plain versions at the flagship
    shape from the burned-in state, one step each on injected noise and on
    the Philox stream; B10 in both phases (its real columns: the padding is
    never read), B7 mask with f32 and bf16 gradient (its padding exactly 0),
    B7' with f32 gradient and with bf16 gradient and the bf16 copy (one bf16
    ulp, beside the CPU witness).  Returns ``({record: max abs error},
    {record: (wrapper, plain version, arguments, keywords)})`` for the
    timings."""
    from pysgmcmc_tpu_torch.ops import fused_update as fu
    from pysgmcmc_tpu_torch.ops import slim_update as su
    from pysgmcmc_tpu_torch.parallel import packed

    device = state.theta.device
    gen = torch.Generator(device=device).manual_seed(4321)
    err, timing = {}, {}
    n = MAIN_CHAINS
    # B10
    _, grad = fused._grads(state.theta, select(SEED, 12345, n))
    args = (state.theta, state.momentum, state.tau, state.g, state.v_hat,
            state.minv, grad)
    dim = fused.dim
    err["B10"] = 0.0
    for burning_in in (True, False):
        for stream, extra in (
                ("injected", dict(noise=torch.randn(
                    state.theta.shape, generator=gen, device=device))),
                ("philox", dict(step=12345))):
            kw = dict(mdecay=0.05, scale_grad=float(N_DATA), **extra)
            want = fu.fused_sghmc_update_ref(*args, EPS, burning_in, SEED,
                                             **kw)
            floor = max(_rel_err(a[:, :dim], b[:, :dim]) for a, b in zip(
                fu.fused_sghmc_update_ref(_nudge(torch, args[0]), *args[1:],
                                          EPS, burning_in, SEED, **kw),
                want))
            got = fu.fused_sghmc_update(*args, EPS, burning_in, SEED, **kw)
            torch.cuda.synchronize()
            err["B10"] = max(err["B10"], _compare(
                torch, ("B10/{}/{} x 1".format(
                    stream, "burning in" if burning_in else "sampling"),
                    ("theta", "v", "tau", "g", "v_hat", "minv")),
                [t[:, :dim] for t in got], [t[:, :dim] for t in want],
                floor))
    kw = dict(mdecay=0.05, scale_grad=float(N_DATA))
    timing["B10"] = (fu.fused_sghmc_update, fu.fused_sghmc_update_ref,
                     args + (EPS, False, 47), dict(kw, step=0))
    del grad, args
    # B7 mask, on the packed slabs of the stacked state
    template = {k: v[0] for k, v in states.position.items()}
    spec = packed.make_pack_spec(template)
    _, grads = packed._stacked_gradient(sampler, states.position, select,
                                        SEED, 12345)
    grads = {k: g.contiguous() for k, g in grads.items()}
    slab = [packed.pack_tree(spec, t) for t in (
        states.position, states.momentum, grads, states.stats.minv)]
    mask = packed.pack_mask(spec, device=device)
    index = packed._noise_index(spec, template).to(device)
    pad = mask[0] == 0
    for tag, grad_dtype in (("B7-mask", torch.float32),
                            ("B7-mask (bf16)", torch.bfloat16)):
        margs = slab[:2] + [slab[2].to(grad_dtype), slab[3], mask]
        err[tag] = 0.0
        for stream, extra in (
                ("injected", dict(noise=torch.randn(
                    slab[0].shape, generator=gen, device=device))),
                ("philox", dict(step=12345, noise_index=index))):
            kw = dict(mdecay=0.05, scale_grad=float(N_DATA), **extra)
            want = su.slim_sghmc_update_ref(*margs, EPS, SEED, **kw)
            floor = max(_rel_err(a, b) for a, b in zip(
                su.slim_sghmc_update_ref(_nudge(torch, margs[0]),
                                         *margs[1:], EPS, SEED, **kw), want))
            got = su.slim_sghmc_update(*margs, EPS, SEED, **kw)
            torch.cuda.synchronize()
            if got[0][:, pad].any() or got[1][:, pad].any():
                raise AssertionError("{}: the padding moved".format(tag))
            err[tag] = max(err[tag], _compare(
                torch, ("{}/{} x 1".format(tag, stream), ("theta", "v")),
                got, want, floor))
        print("  {}: padding columns of theta' and v' exactly 0".format(tag))
        timing[tag] = (su.slim_sghmc_update, su.slim_sghmc_update_ref,
                       margs + [EPS, 47],
                       dict(mdecay=0.05, scale_grad=float(N_DATA), step=0,
                            noise_index=index))
    del slab, margs
    # B7', on the stacked leaves
    lanes = packed.make_lanes_spec(template)

    def rows(out):
        return [packed.pack_lanes(lanes, t, dtype=next(iter(t.values())).dtype)
                for t in out]

    tree = [states.position, states.momentum, grads, states.stats.minv]
    for tag, grad_dtype, emit in (("B7'", torch.float32, False),
                                  ("B7' (bf16)", torch.bfloat16, True)):
        targs = tree[:2] + [{k: g.to(grad_dtype) for k, g in
                             tree[2].items()}, tree[3]]
        labels = ("theta", "v", "theta bf16") if emit else ("theta", "v")
        err[tag] = 0.0
        for stream, extra in (
                ("injected", dict(noise={k: torch.randn(
                    t.shape, generator=gen, device=device)
                    for k, t in tree[0].items()})),
                ("philox", dict(step=12345))):
            kw = dict(mdecay=0.05, scale_grad=float(N_DATA), emit_bf16=emit,
                      **extra)
            want = rows(su.slim_sghmc_update_tree_ref(*targs, EPS, SEED,
                                                      **kw))
            got = rows(su.slim_sghmc_update_tree(*targs, EPS, SEED, **kw))
            torch.cuda.synchronize()
            name = ("{}/{} x 1".format(tag, stream), labels)
            if emit:
                head = [{k: t[:CHECK_CHAINS].cpu() for k, t in a.items()}
                        for a in targs]
                hkw = {k: ({n_: t[:CHECK_CHAINS].cpu() for n_, t in
                            v.items()} if isinstance(v, dict) else v)
                       for k, v in kw.items()}
                flips, total = _bf16_flips(
                    torch, [w[:CHECK_CHAINS].cpu() for w in want],
                    rows(su.slim_sghmc_update_tree_ref(*head, EPS, SEED,
                                                       **hkw)))
                err[tag] = max(err[tag], _compare(
                    torch, name, got, want, ulps=1,
                    witness=flips / total if total else 0.0))
                continue
            floor = max(_rel_err(a, b) for a, b in zip(rows(
                su.slim_sghmc_update_tree_ref(
                    {k: _nudge(torch, t) for k, t in targs[0].items()},
                    *targs[1:], EPS, SEED, **kw)), want))
            err[tag] = max(err[tag], _compare(torch, name, got, want, floor))
        timing[tag] = (su.slim_sghmc_update_tree,
                       su.slim_sghmc_update_tree_ref, targs + [EPS, 47],
                       dict(mdecay=0.05, scale_grad=float(N_DATA), step=0,
                            emit_bf16=emit))
    return err, timing


def _nbytes(torch, values):
    """Bytes of the tensors in ``values`` (tensors, dicts and sequences of
    them), each counted once."""
    if torch.is_tensor(values):
        return values.element_size() * values.numel()
    if isinstance(values, dict):
        values = list(values.values())
    if isinstance(values, (list, tuple)):
        return sum(_nbytes(torch, v) for v in values)
    return 0


def _flat_times(torch, timing, card):
    """Each new kernel at the flagship shape: one launch on a spinning
    stream, median of ONE_STEP_TIMED, beside its plain version (median of
    5) and its bound (every input read once, every output written once;
    its operations as FLAT_OPS over the f32 peak).  Returns ``(timed,
    bounds)``."""
    timed, bounds = {}, {}
    for tag, (fn, ref, args, kw) in timing.items():
        def launch(f=fn, a=args, w=kw):
            return f(*a, **w)

        def plain(f=ref, a=args, w=kw):
            return f(*a, **w)

        outs = _tuple(launch())
        timed[tag] = _median_ms(torch, launch, ONE_STEP_TIMED)
        plain()
        timed[tag + " plain"] = _median_ms(torch, plain, 5)
        n_bytes = _nbytes(torch, list(args) + [kw.get("noise_index")]) \
            + _nbytes(torch, list(outs))
        elements = sum(t.numel() for t in (
            outs[0].values() if isinstance(outs[0], dict) else [outs[0]]))
        compute_ms = elements * FLAT_OPS[tag.split(" ")[0]] / F32_FLOPS * 1e3
        bounds[tag] = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                          (compute_ms, "operations"))
        print("time {} per launch (one step) at {} chains, {} elements: "
              "kernel {:.3f} ms (median of {}), plain {:.3f} ms (median of "
              "5), bound {:.3f} ms ({}; {:.3f} ms for its operations) "
              "({})".format(tag, MAIN_CHAINS, elements, timed[tag],
                            ONE_STEP_TIMED, timed[tag + " plain"],
                            bounds[tag][0], bounds[tag][1], compute_ms,
                            card))
    return timed, bounds


def _flat_drivers_agree(torch, sampler, states, select):
    """The packed, stacked and lanes drivers from one state and one
    generator seed, f32 passes, 2 samples of 8 steps each, on the Philox
    stream with a window per chain: the same chains.  Returns ``(worst
    error, launches of B7 mask in the packed run)``."""
    from pysgmcmc_tpu_torch.ops import slim_update as su
    from pysgmcmc_tpu_torch.parallel import (
        make_lanes_spec,
        pack_lanes,
        sample_chain_lanes,
        sample_chain_packed,
        sample_chain_stacked,
    )

    device = states.step.device
    spec = make_lanes_spec({k: v[0] for k, v in states.position.items()})
    launches = {}

    def run(fn, start, **kw):
        su.slim_sghmc_update.launches = 0
        _, pos, _ = fn(sampler, start,
                       torch.Generator(device=device).manual_seed(5), 2,
                       batch_fn=select, keep_every=8, **kw)
        launches[fn.__name__] = su.slim_sghmc_update.launches
        return [pack_lanes(spec, {k: v[:, i] for k, v in pos.items()})
                for i in range(2)]

    want = run(sample_chain_lanes, states, compute_dtype=None)
    floor = max(_rel_err(a, b) for a, b in zip(run(
        sample_chain_lanes, states._replace(position={
            k: _nudge(torch, v) for k, v in states.position.items()}),
        compute_dtype=None), want))
    worst = 0.0
    for name, fn, kw in (("packed", sample_chain_packed,
                          dict(compute_dtype=None)),
                         ("stacked", sample_chain_stacked, {})):
        got = run(fn, states, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _compare(
            torch, ("{} vs lanes drivers (SGHMC, reference network, eps "
                    "{:g})".format(name, EPS),
                    ("positions after 8 steps", "positions after 16 steps")),
            got, want, floor, what="{} - lanes".format(name)))
    return worst, launches["sample_chain_packed"]


def _fused_functions(fs):
    """fused kernel -> (wrapper, plain version), all twelve."""
    out = {"B1": (fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref),
           "B2": (fs.fused_bnn_multistep_burnin,
                  fs.fused_bnn_multistep_burnin_ref),
           "B3": (fs.fused_bnn_step, fs.fused_bnn_step_ref),
           "B4-sgld": (fs.fused_bnn_step_sgld, fs.fused_bnn_step_sgld_ref),
           "B5-sgld": (fs.fused_bnn_multistep_sgld,
                       fs.fused_bnn_multistep_sgld_ref),
           "B6": (fs.fused_bnn_multistep_burnin_sgld,
                  fs.fused_bnn_multistep_burnin_sgld_ref)}
    out.update(_fused_new_functions(fs))
    return out


def _bf16_args(torch, st, inputs, bf16):
    """The state operands ``inputs`` of ``st``, those in ``bf16`` rounded
    to bfloat16."""
    return tuple(st[k].to(torch.bfloat16) if k in bf16 else st[k]
                 for k in inputs)


def _bf16_kw(torch, kw, bf16):
    """A kernel's keywords with ``state_dtype=bfloat16`` where it has a
    bf16 momentum or accumulator."""
    return dict(kw, state_dtype=torch.bfloat16) if "v" in bf16 else kw


def _bf16_checks(torch, fs, state, kws, x_win, y_win, variant="",
                 rules=None, label=""):
    """Every bf16 instantiation of the fused kernels (of ``variant``:
    ``""``, ``"clt"`` or ``"paired"``; of the samplers ``rules`` where
    given) against its plain version on the Philox stream from the
    burned-in states (CHECK_CHAINS chains) over BF16_STEPS steps (one for
    the one-step kernels), each beside the witness (the plain version on
    the CPU), the bf16 values' ulps those of their largest |value| over the
    plain version's steps.  Returns ``{record: max abs error}``."""
    err = {}
    fns = _fused_functions(fs)
    for name, (rule, inputs, bf16, one_step) in FUSED_BF16.items():
        if variant == "paired" and (name not in PAIRED_KERNELS
                                    or "v" not in bf16):
            continue
        if rules is not None and rule not in rules:
            continue
        fn, ref = fns[name]
        args = _bf16_args(torch, state[rule], inputs, bf16)
        kw = dict(_bf16_kw(torch, kws[rule], bf16), **VARIANT_KW[variant])
        eps = B8_EPS.get(rule, EPS_SGLD if rule == "SGLD" else EPS)
        steps = 1 if one_step else BF16_STEPS

        def run(wrapper, start, x, y, k=steps):
            return _run(fs, wrapper, one_step, start, x, y, eps, kw, k,
                        "philox", dict(step0=12345))

        want = run(ref, args, x_win, y_win)
        outs = [run(ref, args, x_win, y_win, k) for k in range(1, steps)]
        peaks = [torch.stack([o[i].float().abs() for o in outs + [want]])
                 .amax(0) if w.dtype == torch.bfloat16 else None
                 for i, w in enumerate(want)]
        del outs
        witness = run(ref, tuple(a.cpu() for a in args), x_win.cpu(),
                      y_win.cpu())
        flips, total = _bf16_flips(torch, [w.cpu() for w in want], witness)
        got = run(fn, args, x_win, y_win)
        torch.cuda.synchronize()
        labels = FUSED_NEW[name][2] if name in FUSED_NEW else {
            "B2": ("theta", "v", "tau", "g", "v_hat", "minv", "cost"),
            "B4-sgld": ("theta", "cost"), "B5-sgld": ("theta", "cost"),
        }.get(name, ("theta", "v", "cost"))
        record = _record(name + " (bf16)", variant)
        err[record] = _compare(
            torch, ("{}/philox/eps {:g} x {}{}".format(record, eps, steps,
                                                       label), labels),
            got, want, ulps=steps, witness=flips / total if total else 0.0,
            peaks=peaks)
    return err


def _paired_vs_unpaired(torch, fs, state, kws, x_win, y_win):
    """Each paired kernel against its unpaired kernel at MAIN_CHAINS
    chains (the check states tiled) on the Philox stream over CHECK_STEPS
    steps (one for B3): at float32 state bit for bit (the same normals,
    windows and arithmetic), at bf16 state the share of bf16 values the
    once-per-launch rounding moves, printed."""
    fns = _fused_functions(fs)
    rules = {"B1": "SGHMC", "B2": "SGHMC", "B3": "SGHMC", "B5-sgld": "SGLD",
             "B6": "SGLD", **{name: FUSED_NEW[name][0]
                              for name in ("B5-psgld", "B5-sgnht",
                                           "B5-rsghmc")}}
    inputs = {"B1": ("theta", "v", "minv"), "B3": ("theta", "v", "minv"),
              "B2": ("theta", "v", "tau", "g", "v_hat"),
              "B5-sgld": ("theta", "minv"),
              "B6": ("theta", "tau", "g", "v_hat"),
              **{name: FUSED_NEW[name][1] for name in ("B5-psgld", "B5-sgnht",
                                                       "B5-rsghmc")}}
    for name in PAIRED_KERNELS:
        fn = fns[name][0]
        rule = rules[name]
        reps = MAIN_CHAINS // CHECK_CHAINS
        tiled = {k: v.repeat(reps, *(1,) * (v.ndim - 1))
                 for k, v in state[rule].items()}
        eps = B8_EPS.get(rule, EPS_SGLD if rule == "SGLD" else EPS)
        one_step = name == "B3"
        bf16s = [False] + ([True] if "v" in inputs[name]
                           and name != "B5-psgld" else [])
        for bf16 in bf16s:
            args = _bf16_args(torch, tiled, inputs[name],
                              ("v",) if bf16 else ())
            kw = _bf16_kw(torch, kws[rule], ("v",) if bf16 else ())
            out = [_run(fs, fn, one_step, args, x_win, y_win, eps,
                        dict(kw, pair_dots=pair_dots),
                        1 if one_step else CHECK_STEPS, "philox",
                        dict(step0=12345)) for pair_dots in (False, True)]
            torch.cuda.synchronize()
            label = "{} paired vs unpaired ({} state, {} chains x {} steps)"\
                .format(name, "bf16" if bf16 else "f32", MAIN_CHAINS,
                        1 if one_step else CHECK_STEPS)
            if not bf16:
                same = all(torch.equal(a, b) for a, b in zip(*out))
                print("  {}: bit for bit {}".format(label, same))
                if not same:
                    raise AssertionError("{}: outputs differ".format(label))
                continue
            flips, total = _bf16_flips(torch, out[1], out[0])
            print("  {}: {:.3e} of the bf16 momentum values differ; theta "
                  "{:.3e} of its row's scale apart".format(
                      label, flips / total, _rel_err(out[1][0], out[0][0])))


def _predict_rates(torch, bnn, card):
    """Predict's serving rate on ``bnn``'s ensemble at PREDICT_POINTS
    points, f32 and ``compute_dtype=bfloat16`` (median of PREDICT_TIMED
    calls each, after a warm-up, ending in the copy to the host); the bf16
    means must be finite and near the f32 ones."""
    import numpy as np

    x = np.linspace(0.0, 1.0, PREDICT_POINTS)[:, None]
    members = len(bnn.samples["w2"])
    means = {}
    for dtype in (None, torch.bfloat16):
        bnn.predict(x, compute_dtype=dtype)
        times = []
        for _ in range(PREDICT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            means[dtype] = bnn.predict(x, compute_dtype=dtype)[0]
            times.append(time.perf_counter() - t0)
        seconds = sorted(times)[PREDICT_TIMED // 2]
        print("predict ({}): {} members x {} points in {:.4f} s (median of "
              "{}): {:.4e} queries/s, {:.4e} member-queries/s ({})".format(
                  "float32" if dtype is None else "compute_dtype=bfloat16",
                  members, PREDICT_POINTS, seconds, PREDICT_TIMED,
                  PREDICT_POINTS / seconds, members * PREDICT_POINTS / seconds,
                  card))
    gap = float(np.abs(means[torch.bfloat16] - means[None]).max())
    print("predict: max|bf16 mean - f32 mean| = {:.3e} (scale {:.3e})".format(
        gap, float(np.abs(means[None]).max())))
    if not np.isfinite(means[torch.bfloat16]).all() or not gap < 0.05:
        raise AssertionError("predict(compute_dtype=bfloat16): predictions "
                             "not finite or {:.3e} from f32's".format(gap))


def _placed_as_counted(fs, lay, what):
    """Raises unless every fused launch counted in ``fs.placements`` took
    the placement the library's own count gives at layout ``lay`` (batch
    BATCH), and unless some took device memory.  (The burn-in's EMAs live
    in device memory in both placements, so at H = WIDE_H B6's theta and
    gradient fit shared memory, and the others' state does not.)"""
    ids = {"fused_bnn_multistep": fs.B1, "fused_bnn_multistep_burnin": fs.B2,
           "fused_bnn_multistep_sgld": fs.B5_SGLD,
           "fused_bnn_multistep_burnin_sgld": fs.B6}
    wrong = {}
    for (entry, where), count in fs.placements.items():
        base = re.sub(r"_(clt|paired)$", "", entry)
        if where != fs.fused_placement(ids[base], lay, BATCH):
            wrong[(entry, where)] = count
    if wrong or "device" not in {where for _, where in fs.placements}:
        raise AssertionError(
            "{}: fused launches against the library's placement (or none "
            "in device memory): {}; all: {}".format(
                what, wrong, dict(fs.placements)))


def _wide_states(torch, fs, x, y, h, rules=("SGHMC", "SGLD")):
    """The check states of ``rules`` on the ``h``-wide network after
    BURNED_IN burn-in steps (CHECK_CHAINS chains) on Box-Muller normals,
    packed as in main; returns the layout and ``{rule: {name: tensor}}``.
    (Their SGLD states amplify a 1e-7 nudge of theta beyond what a
    CHECK_STEPS check resolves: WIDE_SGLD_STEPS.)"""
    from pysgmcmc_tpu_torch.samplers import SGHMCSampler, SGLDSampler

    lay = fs.FusedLayout(1, h, 3)
    state = {}
    for rule in rules:
        sampler_cls = {"SGHMC": SGHMCSampler, "SGLD": SGLDSampler}[rule]
        burned = _burned_in(torch, x, y, sampler_cls, CHECK_CHAINS, x.device,
                            h=h, noise_impl="box_muller")[1]
        state[rule] = {"theta": fs.pack(burned.position, lay)}
        state[rule].update(zip(("tau", "g", "v_hat", "minv"), (
            fs.pack(leaf, lay) for leaf in burned.stats)))
        if rule == "SGHMC":
            state[rule]["v"] = fs.pack(burned.momentum, lay)
    return lay, state


def _variant_plan(plan, stream):
    """A variant's plan: the checked entries of Box-Muller's ``plan`` on
    ``stream`` alone (the floors of the unchecked ones are Box-Muller's,
    printed with them)."""
    return [(eps, k, True, (stream,)) for eps, k, checked, *_ in plan
            if checked]


def _chunked_equal(torch, what, fn, state, x_win, y_win, eps, kw, k):
    """Raises unless two launches of ``k`` steps of the multi-step wrapper
    ``fn`` from ``state`` (its leading inputs, continued from the first
    launch's outputs) equal one launch of 2k steps bit for bit."""
    seed = 2**40 + 1
    once = fn(*state, x_win, y_win, eps, seed, k_steps=2 * k, step0=5, **kw)
    first = fn(*state, x_win, y_win, eps, seed, k_steps=k, step0=5, **kw)
    twice = fn(*first[:len(state)], x_win, y_win, eps, seed, k_steps=k,
               step0=5 + k, **kw)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(once, twice)]
    print("  {}: {} + {} steps equal {} bit for bit: {}".format(
        what, k, k, 2 * k, same))
    if not all(same):
        raise AssertionError("{}: two launches of {} steps differ from one "
                             "of {}".format(what, k, 2 * k))


def _wide_checks(torch, fs, checks, x, y, x_win, y_win, base, gen):
    """The wide kernels against their plain versions: B1, B2, B5-sgld and
    B6 at WIDE_H and B6 at DEVICE_H, each from the check states of its
    width (:func:`_wide_states`) with its ``checks`` entry's plan (the SGLD
    entries' at EPS_SGLD over WIDE_SGLD_STEPS), Box-Muller on injected
    noise and Philox, the CLT on its stream; at DEVICE_H also two launches
    of B6 equal to one bit for bit on both generators.  Raises unless every
    fused launch took the placement the library's count gives (at DEVICE_H
    device memory).  Returns ``{record: max abs error}``."""
    err = {}
    for h, kernels in ((WIDE_H, ("B1", "B2", "B5-sgld", "B6")),
                       (DEVICE_H, ("B6",))):
        entries = [entry for entry in checks if entry[0] in kernels]
        lay, state = _wide_states(torch, fs, x, y, h,
                                  rules=sorted({e[3] for e in entries}))
        kw = dict(base, h=h, prior_scale=1.0 / (lay.n_params * N_DATA))
        kw = {"SGHMC": dict(kw, mdecay=0.05), "SGLD": dict(kw, a_coef=1.0)}
        noise = torch.randn((CHECK_STEPS, CHECK_CHAINS, lay.n_params),
                            generator=gen, device=x.device)
        widx = torch.randint(0, x_win.shape[0], (CHECK_STEPS, CHECK_CHAINS),
                             generator=gen, device=x.device,
                             dtype=torch.int32)
        plans = {}
        for name, _, _, _, _, _, _, plan in entries:
            steps = WIDE_SGLD_STEPS.get((name, h))
            plans[name] = plan if steps is None else [
                (EPS_SGLD, CHECK_STEPS, False), (EPS_SGLD, steps, True),
                *plan[1:]]
        fs.placements.clear()
        err.update(_kernel_checks(torch, fs, [
            (_record("{} (H={})".format(name, h), variant), fn, ref,
             tuple(state[rule][k] for k in inputs), kw[rule], labels, False,
             _variant_plan(plans[name], "clt") if variant else plans[name])
            for name, fn, ref, rule, inputs, labels, _, _ in entries
            for variant in ("", "clt")], x_win, y_win,
            [("injected", dict(noise=noise, widx=widx)),
             ("philox", dict(step0=12345)),
             ("clt", dict(step0=12345, **VARIANT_KW["clt"]))]))
        if h == DEVICE_H:
            for name, fn, _, rule, inputs, _, _, _ in entries:
                for variant in ("", "clt"):
                    _chunked_equal(
                        torch, _record("{} (H={})".format(name, h), variant),
                        fn, tuple(state[rule][k] for k in inputs), x_win,
                        y_win, EPS_SGLD, dict(kw[rule], **VARIANT_KW[variant]),
                        CHECK_STEPS // 2)
        print("wide kernel checks (H={}, P={}): fused launches by placement "
              "{}".format(h, lay.n_params, dict(fs.placements)))
        _placed_as_counted(fs, lay, "the H={} kernel checks".format(h))
        if h == DEVICE_H and {w for _, w in fs.placements} != {"device"}:
            raise AssertionError("the H={} checks did not all run in device "
                                 "memory: {}".format(h, dict(fs.placements)))
        del noise, widx, state
    return err


def main():
    import numpy as np
    import torch

    wall_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    from pysgmcmc_tpu_torch.models import dense_network
    from pysgmcmc_tpu_torch.ops import _build, fused_step as fs
    from pysgmcmc_tpu_torch.ops import pairwise
    from pysgmcmc_tpu_torch.ops import slim_update as su
    from pysgmcmc_tpu_torch.ops import svgd_streaming as ss
    from pysgmcmc_tpu_torch.samplers import SGHMCSampler, SGLDSampler
    from pysgmcmc_tpu_torch.sampling import Sampler

    card = _card()
    print(card)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (plain versions run full f32)")
    device = torch.device("cuda")

    paths, seconds = _build.build()
    for source in _build.SOURCES:
        _build.load(source)
    print("build: {} in {:.1f} s, one nvcc per source (three per fused "
          "source) in parallel (0.0 = already built)".format(", ".join(
              os.path.relpath(path, HERE) for path in paths.values()),
              seconds))
    reports = {}
    for source, kernel, instances, tags in (
            ("fused_step", "fused_kernel", INSTANCES,
             (" (device)", " (bf16)")),
            ("slim_update", "slim_kernel", SLIM_INSTANCES, (" (bf16)",))):
        with open(_build.log_path(source)) as f:
            reports.update(_ptxas_report(
                f.read(), kernel, instances, tags=tags,
                layouts=SLIM_LAYOUTS if source == "slim_update" else None))
    # the CLT and paired instantiations (the paired ones resident only)
    for source, tag in (("fused_step_clt", "clt"),
                        ("fused_step_paired", "paired")):
        with open(_build.log_path(source)) as f:
            found = _ptxas_report(f.read(), "fused_kernel", INSTANCES,
                                  complete=tag == "clt",
                                  tags=(" (device)", " (bf16)"))
        reports.update({_record(name, tag): line
                        for name, line in found.items()})
    missing = set(PAIRED_KERNELS) - {name.split(" ")[0] for name in reports
                                     if "paired" in name}
    if missing:
        raise AssertionError("ptxas report lacks paired kernels: {}".format(
            sorted(missing)))
    with open(_build.log_path("svgd_streaming")) as f:
        reports.update(_ptxas_svgd(f.read()))
    for name, line in sorted(reports.items()):
        print("ptxas {}: {}".format(name, line))

    x_np, y_np, x, y = _data(torch, device)
    x_win, y_win = fs.data_windows(x, y, BATCH)
    n_windows = x_win.shape[0]
    init_fn, apply_fn = dense_network(1, units=(H, H, H), device=device)
    lay = fs.FusedLayout(1, H, 3)
    P = lay.n_params
    gen = torch.Generator(device=device).manual_seed(1234)
    base = dict(scale_grad=float(N_DATA), prior_scale=1.0 / (P * N_DATA),
                batch_size=BATCH, n_data=N_DATA, h=H)
    sghmc = dict(base, mdecay=0.05)
    sgld = dict(base, a_coef=1.0)
    # the fused kernels' keywords of the samplers without a mass matrix
    fused_kw = {"PSGLD": dict(base, alpha=0.99, lambda_reg=1e-5),
                "SGNHT": dict(base, a_diff=1.0),
                "RelativisticSGHMC": dict(
                    {k: v for k, v in base.items() if k != "scale_grad"},
                    mass=1.0, speed_of_light=1.0, d_coef=1.0, b_hat=0.0)}

    # ---- every kernel vs its plain version at the flagship shapes ----
    n = CHECK_CHAINS
    noise = torch.randn((CHECK_STEPS, n, P), generator=gen, device=device)
    widx = torch.randint(0, n_windows, (CHECK_STEPS, n), generator=gen,
                         device=device, dtype=torch.int32)
    streams = [("injected", dict(noise=noise, widx=widx)),
               ("philox", dict(step0=12345))]
    # the check states, burned in on the CLT (the main path's generator),
    # and on Box-Muller (state_bm) for the CLT kernels' bf16 checks
    state, state_bm = {}, {}
    for sampler_cls in (SGHMCSampler, SGLDSampler):
        rule = sampler_cls.__name__[:-7]
        for states, noise_impl in ((state, "auto"),
                                   (state_bm, "box_muller")):
            burned = _burned_in(torch, x, y, sampler_cls, n, device,
                                noise_impl=noise_impl)[1]
            states[rule] = {"theta": fs.pack(burned.position, lay)}
            states[rule].update(zip(("tau", "g", "v_hat", "minv"), (
                fs.pack(leaf, lay) for leaf in burned.stats)))
            if rule == "SGHMC":
                states[rule]["v"] = fs.pack(burned.momentum, lay)
        print("{} check state after {} burn-in steps at eps {:g}: ".format(
            rule, BURNED_IN, EPS) + ", ".join(
                "{} in [{:.3e}, {:.3e}]".format(k, float(t.min()),
                                                float(t.max()))
                for k, t in sorted(state[rule].items())))
    for method, st in _lanes_check_states(torch, x, y).items():
        state[method] = {k: v.to(device) for k, v in st.items()}
        print("{} check state after {} lanes steps at eps {:g} (CPU): ".format(
            method, BURNED_IN, B8_EPS[method]) + ", ".join(
                "{} in [{:.3e}, {:.3e}]".format(k, float(t.min()),
                                                float(t.max()))
                for k, t in sorted(state[method].items())))
    sghmc_plan = [(EPS, CHECK_STEPS, True)]
    sgld_plan = [(EPS_SGLD, CHECK_STEPS, True), (EPS, 1, True),
                 (EPS, CHECK_STEPS, False)]
    checks = [
        ("B2", fs.fused_bnn_multistep_burnin, fs.fused_bnn_multistep_burnin_ref,
         "SGHMC", ("theta", "v", "tau", "g", "v_hat"),
         ("theta", "v", "tau", "g", "v_hat", "minv", "cost"), False,
         sghmc_plan),
        ("B1", fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref, "SGHMC",
         ("theta", "v", "minv"), ("theta", "v", "cost"), False, sghmc_plan),
        ("B3", fs.fused_bnn_step, fs.fused_bnn_step_ref, "SGHMC",
         ("theta", "v", "minv"), ("theta", "v", "cost"), True, sghmc_plan),
        ("B6", fs.fused_bnn_multistep_burnin_sgld,
         fs.fused_bnn_multistep_burnin_sgld_ref, "SGLD",
         ("theta", "tau", "g", "v_hat"),
         ("theta", "tau", "g", "v_hat", "minv", "cost"), False, sgld_plan),
        ("B5-sgld", fs.fused_bnn_multistep_sgld,
         fs.fused_bnn_multistep_sgld_ref, "SGLD", ("theta", "minv"),
         ("theta", "cost"), False, sgld_plan),
        ("B4-sgld", fs.fused_bnn_step_sgld, fs.fused_bnn_step_sgld_ref, "SGLD",
         ("theta", "minv"), ("theta", "cost"), True, sgld_plan[:2]),
    ]
    # the CLT instantiations on the CLT stream (Philox, its own purpose) and
    # the paired ones on the Philox stream, each plan as Box-Muller's
    streams.append(("clt", dict(step0=12345, **VARIANT_KW["clt"])))

    err = _kernel_checks(torch, fs, [
        (_record(name, variant), fn, ref,
         tuple(state[rule][k] for k in inputs),
         dict(sghmc if rule == "SGHMC" else sgld,
              **({} if variant == "clt" else VARIANT_KW[variant])),
         labels, one_step,
         plan if not variant else _variant_plan(
             plan, "clt" if variant == "clt" else "philox"))
        for name, fn, ref, rule, inputs, labels, one_step, plan in checks
        for variant in ("", "clt", "paired")
        if variant != "paired" or name in PAIRED_KERNELS],
        x_win, y_win, streams)
    # the slim kernels at the flagship shape, from the same burned-in states
    prior = dict(prior_scale=1.0 / (P * N_DATA))
    slim_kw = {"SGHMC": dict(prior, mdecay=0.05, scale_grad=float(N_DATA)),
               "SGLD": dict(prior, a_coef=1.0, scale_grad=float(N_DATA)),
               "PSGLD": dict(prior, alpha=0.99, lambda_reg=1e-5,
                             scale_grad=float(N_DATA)),
               "RelativisticSGHMC": dict(prior, d_coef=1.0, bhat=0.0,
                                         mass=1.0, speed_of_light=1.0),
               "SGNHT": dict(prior, a_diff=1.0, scale_grad=float(N_DATA))}
    slim_states = _slim_states(torch, fs, state, lay, x_win, y_win)
    err.update(_slim_checks(torch, su, slim_states, slim_kw))
    # bf16 state: every bf16 instantiation from the same burned-in states,
    # the slim kernels at the flagship shape
    for variant in ("", "clt", "paired"):
        err.update(_bf16_checks(torch, fs, state,
                                dict(fused_kw, SGHMC=sghmc, SGLD=sgld),
                                x_win, y_win, variant))
    # the CLT's bf16 kernels of SGHMC and SGLD from the Box-Muller-burned
    # states too (where the final values' ulps did not bound B1's)
    for record, e in _bf16_checks(
            torch, fs, state_bm, dict(SGHMC=sghmc, SGLD=sgld), x_win, y_win,
            "clt", rules=("SGHMC", "SGLD"),
            label=" (Box-Muller-burned state)").items():
        err[record] = max(err[record], e)
    del state_bm
    err.update(_slim_checks(torch, su, slim_states, slim_kw, bf16=True))
    # the fused kernels without a mass matrix: their CLT and paired
    # instantiations at CHECK_CHAINS chains, from the lanes check states
    new_plan = {method: [(eps, k, checked) for eps, k, checked, *names in plan
                         if not names] for method, plan in
                FUSED_NEW_PLAN.items()}
    err.update(_kernel_checks(torch, fs, [
        (_record(name, variant), fn, ref,
         tuple(state[method][k] for k in FUSED_NEW[name][1]),
         dict(fused_kw[method],
              **({} if variant == "clt" else VARIANT_KW[variant])),
         FUSED_NEW[name][2], name.startswith("B4"),
         [(eps, k, checked, ("clt" if variant == "clt" else "philox",))
          for eps, k, checked in new_plan[method]])
        for name, (fn, ref) in _fused_new_functions(fs).items()
        for method in [FUSED_NEW[name][0]]
        for variant in ("clt", "paired")
        if variant == "clt" or name in PAIRED_KERNELS], x_win, y_win,
        streams))
    # paired against unpaired at the flagship's chains
    _paired_vs_unpaired(torch, fs, state,
                        dict(fused_kw, SGHMC=sghmc, SGLD=sgld), x_win, y_win)
    lanes_states = {method: state[method] for method in B8_EPS}
    del noise, widx, state
    # the wide kernels at H = WIDE_H (B6 again at DEVICE_H), state in device
    # memory (B6's theta and gradient at WIDE_H in shared memory)
    err.update(_wide_checks(torch, fs, checks, x, y, x_win, y_win, base, gen))
    # the fused kernels without a mass matrix, from the lanes check states
    # tiled to the flagship's chains
    n = MAIN_CHAINS
    big = {method: {k: v.repeat(n // CHECK_CHAINS, *(1,) * (v.ndim - 1))
                    for k, v in st.items()}
           for method, st in lanes_states.items()}
    noise = torch.randn((CHECK_STEPS, n, P), generator=gen, device=device)
    widx = torch.randint(0, n_windows, (CHECK_STEPS, n), generator=gen,
                         device=device, dtype=torch.int32)
    streams = [("injected", dict(noise=noise, widx=widx)),
               ("zero", dict(noise=torch.zeros_like(noise),
                             widx=torch.zeros_like(widx))),
               ("philox", dict(step0=12345))]
    err.update(_kernel_checks(torch, fs, [
        (name, fn, ref, tuple(big[method][k] for k in FUSED_NEW[name][1]),
         fused_kw[method], FUSED_NEW[name][2], name.startswith("B4"),
         FUSED_NEW_PLAN[method])
        for name, (fn, ref) in _fused_new_functions(fs).items()
        for method in [FUSED_NEW[name][0]]], x_win, y_win, streams))
    del noise, widx, streams

    # ---- times at the main path's shape: 8192 chains, k = 200 ----
    n, k = MAIN_CHAINS, SAMPLE_STEPS
    theta = fs.pack(init_fn(gen, (n,)), lay)
    zeros, ones = torch.zeros_like(theta), torch.ones_like(theta)
    timed, bounds = {}, {}
    timed_args = {}  # Box-Muller record -> its timing's inputs
    table = 4 * n_windows * BATCH * 2  # the x and y window tables

    def nbytes(tensors):
        return sum(t.element_size() * t.numel() for t in tensors
                   if torch.is_tensor(t))

    def time_multi(name, fn, ref, args, kw, step0=0, layout=lay,
                   chains=None, steps=k):
        """Times launches of ``steps`` steps, the median of MULTI_TIMED
        (the plain version: one); the bound counts every tensor argument
        read once (the state and the window tables) and every output
        written once, each in its own type."""
        timed_args[name] = (fn, ref, args, kw, step0, layout, chains)
        fn(*args, k_steps=2, step0=step0, **kw)  # warm-up
        times = []
        for _ in range(MULTI_TIMED):
            ms, out = _time_ms(
                torch, lambda: fn(*args, k_steps=steps, step0=step0, **kw))
            times.append(ms)
        timed[name] = sorted(times)[MULTI_TIMED // 2]
        ref(*args, k_steps=2, step0=step0, **kw)
        timed[name + " plain"], _ = _time_ms(
            torch, lambda: ref(*args, k_steps=steps, step0=step0, **kw))
        flops = _flops_per_chain_step(layout, BATCH,
                                      RULE_FLOPS[name.split(" ")[0]],
                                      _variant_of(name))
        bounds[name] = _bound(chains or n, steps, flops,
                              nbytes(args) + nbytes(out))
        return out

    out = time_multi("B2", fs.fused_bnn_multistep_burnin,
                     fs.fused_bnn_multistep_burnin_ref,
                     (theta, zeros, ones, ones, ones, x_win, y_win, EPS, 42),
                     sghmc)
    time_multi("B1", fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref,
               (out[0], out[1], out[5], x_win, y_win, EPS, 43), sghmc,
               step0=k)
    out = time_multi("B6", fs.fused_bnn_multistep_burnin_sgld,
                     fs.fused_bnn_multistep_burnin_sgld_ref,
                     (theta, ones, ones, ones, x_win, y_win, EPS_SGLD, 44),
                     sgld)
    time_multi("B5-sgld", fs.fused_bnn_multistep_sgld,
               fs.fused_bnn_multistep_sgld_ref,
               (out[0], out[4], x_win, y_win, EPS_SGLD, 45), sgld, step0=k)
    minv_big = out[4]
    new_fns = _fused_new_functions(fs)
    for name in ("B5-psgld", "B5-rsghmc", "B5-sgnht"):
        method, inputs, _ = FUSED_NEW[name]
        time_multi(name, *new_fns[name],
                   (*(big[method][key] for key in inputs), x_win, y_win,
                    B8_EPS[method], 48), fused_kw[method], step0=BURNED_IN)
    # the same at bf16 state: the momentum (and SGHMC's and SGLD's minv)
    # in bf16
    bf = torch.bfloat16
    out = time_multi("B2 (bf16)", fs.fused_bnn_multistep_burnin,
                     fs.fused_bnn_multistep_burnin_ref,
                     (theta, zeros.to(bf), ones, ones, ones, x_win, y_win,
                      EPS, 42), dict(sghmc, state_dtype=bf))
    time_multi("B1 (bf16)", fs.fused_bnn_multistep,
               fs.fused_bnn_multistep_ref,
               (out[0], out[1], out[5].to(bf), x_win, y_win, EPS, 43),
               dict(sghmc, state_dtype=bf), step0=k)
    time_multi("B5-sgld (bf16)", fs.fused_bnn_multistep_sgld,
               fs.fused_bnn_multistep_sgld_ref,
               (out[0], minv_big.to(bf), x_win, y_win, EPS_SGLD, 45), sgld,
               step0=k)
    for name in ("B5-rsghmc", "B5-sgnht"):
        method, inputs, _ = FUSED_NEW[name]
        time_multi(name + " (bf16)", *new_fns[name],
                   _bf16_args(torch, big[method], inputs, ("v",))
                   + (x_win, y_win, B8_EPS[method], 48),
                   dict(fused_kw[method], state_dtype=bf), step0=BURNED_IN)
    for name in ("B2", "B1", "B6", "B5-sgld", "B5-psgld", "B5-rsghmc",
                 "B5-sgnht", "B2 (bf16)", "B1 (bf16)", "B5-sgld (bf16)",
                 "B5-rsghmc (bf16)", "B5-sgnht (bf16)"):
        print("time {} at {} chains x {} steps: kernel {:.2f} ms (median of "
              "{}), plain {:.2f} ms (one launch), bound {:.2f} ms ({}) "
              "({})".format(name, n, k, timed[name], MULTI_TIMED,
                            timed[name + " plain"], bounds[name][0],
                            bounds[name][1], card))
    # the CLT and paired instantiations on the same inputs, VARIANT_STEPS
    # steps a launch
    for name in list(timed_args):
        fn, ref, args, kw, step0, _, _ = timed_args[name]
        for variant in ("clt", "paired"):
            if variant == "paired" and (
                    name.split(" ")[0] not in PAIRED_KERNELS
                    or name == "B5-sgld (bf16)"):
                continue
            record = _record(name, variant)
            time_multi(record, fn, ref, args, dict(kw, **VARIANT_KW[variant]),
                       step0=step0, steps=VARIANT_STEPS)
            print("time {} at {} chains x {} steps: kernel {:.2f} ms (median "
                  "of {}), plain {:.2f} ms (one launch), bound {:.2f} ms ({}) "
                  "({})".format(record, n, VARIANT_STEPS, timed[record],
                                MULTI_TIMED, timed[record + " plain"],
                                bounds[record][0], bounds[record][1], card))
    # one-step kernels: one launch (one step) at 8192 chains, Philox stream
    sel = fs.gather_batch(x_win, y_win, fs.philox_windows(46, 0, n, n_windows,
                                                          device))
    one_step = {
        "B3": (fs.fused_bnn_step, fs.fused_bnn_step_ref,
               (theta, zeros, minv_big), EPS, sghmc),
        "B4-sgld": (fs.fused_bnn_step_sgld, fs.fused_bnn_step_sgld_ref,
                    (theta, minv_big), EPS_SGLD, sgld),
    }
    for name in ("B4-psgld", "B4-rsghmc", "B4-sgnht"):
        method, inputs, _ = FUSED_NEW[name]
        one_step[name] = (*new_fns[name],
                          tuple(big[method][key] for key in inputs),
                          B8_EPS[method], fused_kw[method])
    one_step["B3 (bf16)"] = (fs.fused_bnn_step, fs.fused_bnn_step_ref,
                             (theta, zeros.to(bf), minv_big.to(bf)), EPS,
                             dict(sghmc, state_dtype=bf))
    one_step["B4-sgld (bf16)"] = (fs.fused_bnn_step_sgld,
                                  fs.fused_bnn_step_sgld_ref,
                                  (theta, minv_big.to(bf)), EPS_SGLD, sgld)
    for name in ("B4-rsghmc", "B4-sgnht"):
        method, inputs, _ = FUSED_NEW[name]
        one_step[name + " (bf16)"] = (
            *new_fns[name], _bf16_args(torch, big[method], inputs, ("v",)),
            B8_EPS[method], dict(fused_kw[method], state_dtype=bf))
    for name in list(one_step):
        fn, ref, state, eps, kw = one_step[name]
        one_step[_record(name, "clt")] = (fn, ref, state, eps,
                                          dict(kw, **VARIANT_KW["clt"]))
        if name.split(" ")[0] == "B3":
            one_step[_record(name, "paired")] = (
                fn, ref, state, eps, dict(kw, **VARIANT_KW["paired"]))
    for name, (fn, ref, state, eps, kw) in one_step.items():
        def launch(f=fn, s=state, e=eps, w=kw):
            return f(*s, *sel, e, 46, step=0, **w)

        def plain(f=ref, s=state, e=eps, w=kw):
            return f(*s, *sel, e, 46, step=0, **w)

        out = launch()
        timed[name] = _median_ms(torch, launch, ONE_STEP_TIMED)
        plain()
        timed[name + " plain"] = _median_ms(torch, plain, 5)
        flops = _flops_per_chain_step(lay, BATCH,
                                      RULE_FLOPS[name.split(" ")[0]],
                                      _variant_of(name))
        # the state and the gathered rows read once, the outputs written once
        bounds[name] = _bound(n, 1, flops,
                              nbytes(state) + nbytes(sel) + nbytes(out))
        print("time {} per launch (one step) at {} chains: kernel {:.3f} ms "
              "(median of {}), plain {:.3f} ms (median of 5), bound {:.3f} "
              "ms ({}) ({})".format(name, n, timed[name], ONE_STEP_TIMED,
                                    timed[name + " plain"], bounds[name][0],
                                    bounds[name][1], card))
    # slim kernels: one launch (one step) at the flagship shape, Philox;
    # f32 operands, then bf16 v, minv and gradient
    for name, (fn, ref) in [*_slim_functions(su).items(),
                            *((name + " (bf16)", fns) for name, fns in
                              _slim_functions(su).items())]:
        rule, operands, labels, eps = SLIM[name.split(" ")[0]]
        args = _slim_args(name.split(" ")[0], slim_states[rule])
        if name.endswith("(bf16)"):
            args = [a.to(bf) if key in SLIM_BF16 else a
                    for key, a in zip(operands, args)]

        def launch(f=fn, a=args, e=eps, w=slim_kw[rule]):
            return f(*a, e, 47, step=0, **w)

        def plain(f=ref, a=args, e=eps, w=slim_kw[rule]):
            return f(*a, e, 47, step=0, **w)

        outs = _tuple(launch())
        timed[name] = _median_ms(torch, launch, ONE_STEP_TIMED)
        plain()
        timed[name + " plain"] = _median_ms(torch, plain, 5)
        n_bytes = nbytes(args) + nbytes(outs)
        compute_ms = n * P * SLIM_OPS[name.split(" ")[0]] / F32_FLOPS * 1e3
        bounds[name] = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                           (compute_ms, "operations"))
        print("time {} per launch (one step) at {} chains x {} parameters: "
              "kernel {:.3f} ms (median of {}), plain {:.3f} ms (median of "
              "5), bound {:.3f} ms ({}; {:.3f} ms for its operations) "
              "({})".format(name, n, P, timed[name], ONE_STEP_TIMED,
                            timed[name + " plain"], bounds[name][0],
                            bounds[name][1], compute_ms, card))
    del theta, zeros, ones, out, minv_big, sel, slim_states, big, outs
    torch.cuda.empty_cache()
    # the wide kernels at WIDE_CHAINS chains x WIDE_STEPS steps, state in
    # device memory (B6's theta and gradient at WIDE_H in shared memory);
    # B6 at DEVICE_H, its state in device memory
    wide_lay = fs.FusedLayout(1, WIDE_H, 3)
    wide_theta = fs.pack(dense_network(1, units=(WIDE_H,) * 3, device=device)[
        0](gen, (WIDE_CHAINS,)), wide_lay)
    wz, wo = torch.zeros_like(wide_theta), torch.ones_like(wide_theta)
    wide_kw = dict(layout=wide_lay, chains=WIDE_CHAINS, steps=WIDE_STEPS)
    wide_base = dict(base, h=WIDE_H,
                     prior_scale=1.0 / (wide_lay.n_params * N_DATA))
    wide_sghmc = dict(wide_base, mdecay=0.05)
    wide_sgld = dict(wide_base, a_coef=1.0)
    tag = " (H={})".format(WIDE_H)
    out = time_multi("B2" + tag, fs.fused_bnn_multistep_burnin,
                     fs.fused_bnn_multistep_burnin_ref,
                     (wide_theta, wz, wo, wo, wo, x_win, y_win, EPS, 42),
                     wide_sghmc, **wide_kw)
    time_multi("B1" + tag, fs.fused_bnn_multistep, fs.fused_bnn_multistep_ref,
               (out[0], out[1], out[5], x_win, y_win, EPS, 43), wide_sghmc,
               step0=WIDE_STEPS, **wide_kw)
    out = time_multi("B6" + tag, fs.fused_bnn_multistep_burnin_sgld,
                     fs.fused_bnn_multistep_burnin_sgld_ref,
                     (wide_theta, wo, wo, wo, x_win, y_win, EPS_SGLD, 44),
                     wide_sgld, **wide_kw)
    time_multi("B5-sgld" + tag, fs.fused_bnn_multistep_sgld,
               fs.fused_bnn_multistep_sgld_ref,
               (out[0], out[4], x_win, y_win, EPS_SGLD, 45), wide_sgld,
               step0=WIDE_STEPS, **wide_kw)
    for name in ("B2", "B1", "B6", "B5-sgld"):
        fn, ref, args, kw, step0, _, _ = timed_args[name + tag]
        time_multi(_record(name + tag, "clt"), fn, ref, args,
                   dict(kw, **VARIANT_KW["clt"]), step0=step0, **wide_kw)
    del wide_theta, wz, wo, out
    dev_lay = fs.FusedLayout(1, DEVICE_H, 3)
    dev_theta = fs.pack(dense_network(1, units=(DEVICE_H,) * 3,
                                      device=device)[0](gen, (WIDE_CHAINS,)),
                        dev_lay)
    do = torch.ones_like(dev_theta)
    dev_tag = " (H={})".format(DEVICE_H)
    for variant in ("", "clt"):
        time_multi(_record("B6" + dev_tag, variant),
                   fs.fused_bnn_multistep_burnin_sgld,
                   fs.fused_bnn_multistep_burnin_sgld_ref,
                   (dev_theta, do, do, do, x_win, y_win, EPS_SGLD, 44),
                   dict(base, h=DEVICE_H, a_coef=1.0, prior_scale=1.0 / (
                       dev_lay.n_params * N_DATA), **VARIANT_KW[variant]),
                   layout=dev_lay, chains=WIDE_CHAINS, steps=WIDE_STEPS)
    del dev_theta, do
    for name, kernel_id, w_lay in (
            ("B2" + tag, fs.B2, wide_lay), ("B1" + tag, fs.B1, wide_lay),
            ("B6" + tag, fs.B6, wide_lay),
            ("B5-sgld" + tag, fs.B5_SGLD, wide_lay),
            ("B6" + dev_tag, fs.B6, dev_lay)):
        for record in (name, _record(name, "clt")):
            print("time {} at {} chains x {} steps (P = {}, state in {} "
                  "memory): kernel {:.2f} ms (median of {}), plain {:.2f} ms "
                  "(one launch), bound {:.2f} ms ({}) ({})".format(
                      record, WIDE_CHAINS, WIDE_STEPS, w_lay.n_params,
                      fs.fused_placement(kernel_id, w_lay, BATCH),
                      timed[record], MULTI_TIMED, timed[record + " plain"],
                      bounds[record][0], bounds[record][1], card))
    del timed_args
    torch.cuda.empty_cache()

    # ---- the one-step driver vs the multi-step driver on the card ----
    launches = {}
    # one-step kernel -> (its wrapper, the sampler, its states)
    drivers = {"B3": (fs.fused_bnn_step, *_burned_in(
                   torch, x, y, SGHMCSampler, DRIVER_CHAINS, device)),
               "B4-sgld": (fs.fused_bnn_step_sgld, *_burned_in(
                   torch, x, y, SGLDSampler, DRIVER_CHAINS, device))}
    for name in ("B4-psgld", "B4-rsghmc", "B4-sgnht"):
        method = FUSED_NEW[name][0]
        sampler = _sampler(method, B8_EPS[method])
        drivers[name] = (new_fns[name][0], sampler, _packed_states(
            torch, sampler, lanes_states[method], DRIVER_CHAINS))
    multi_of = {"B3": ("B1", fs.fused_bnn_multistep),
                "B4-sgld": ("B5-sgld", fs.fused_bnn_multistep_sgld),
                "B4-psgld": ("B5-psgld", fs.fused_bnn_multistep_psgld),
                "B4-sgnht": ("B5-sgnht", fs.fused_bnn_multistep_sgnht),
                "B4-rsghmc": ("B5-rsghmc", fs.fused_bnn_multistep_rsghmc)}
    # each driver with each generator: Box-Muller, then the CLT (the
    # fused drivers' default)
    for noise_impl, variant in (("box_muller", ""), ("hadamard_clt", "clt")):
        for name, (kernel, sampler, states) in drivers.items():
            multi_name, multi_kernel = multi_of[name]
            err_driver, one, multi = _driver_check(
                torch, x, y, sampler, states, kernel, multi_kernel,
                noise_impl=noise_impl)
            launches[_record(name, variant)] = one
            launches[_record(multi_name, variant)] = \
                launches.get(_record(multi_name, variant), 0) + multi
            print("one-step driver ({}, {}): {} chains x {} steps, "
                  "max|one-step - multi-step| = {:.3e}, {} launches of {}, "
                  "{} of {}".format(
                      type(sampler).__name__, noise_impl, DRIVER_CHAINS,
                      DRIVER_SAMPLES * DRIVER_KEEP, err_driver, one,
                      _record(name, variant), multi,
                      _record(multi_name, variant)))
            if one != DRIVER_SAMPLES * DRIVER_KEEP or multi != DRIVER_SAMPLES:
                raise AssertionError("{}: {} and {} launches".format(
                    _record(name, variant), one, multi))
    # the same drivers at bf16 state, JAX's default (pSGLD's accumulator
    # stays f32): SGHMC burns in with it (B2), then the one-step and the
    # multi-step kernels run their bf16 instantiations
    from pysgmcmc_tpu_torch.parallel import burnin_chain_fused

    sghmc_sampler = drivers["B3"][1]
    del multi_of["B4-psgld"]  # its accumulator stays f32
    for noise_impl, variant in (("box_muller", ""), ("hadamard_clt", "clt")):
        _zero_counts(fs.fused_bnn_multistep_burnin)
        init_gen = torch.Generator(device=device).manual_seed(11)
        drivers["B3"] = (fs.fused_bnn_step, sghmc_sampler, burnin_chain_fused(
            sghmc_sampler, sghmc_sampler.init(init_fn(init_gen,
                                                      (DRIVER_CHAINS,))),
            init_gen, BURNED_IN, x, y, noise_impl=noise_impl))
        launches[_record("B2 (bf16)", variant)] = _launches(
            fs.fused_bnn_multistep_burnin, variant)
        for name, (multi_name, multi_kernel) in multi_of.items():
            kernel, sampler, states = drivers[name]
            err_driver, one, multi = _driver_check(
                torch, x, y, sampler, states, kernel, multi_kernel,
                state_dtype=torch.bfloat16, noise_impl=noise_impl)
            launches[_record(name + " (bf16)", variant)] = one
            launches[_record(multi_name + " (bf16)", variant)] = multi
            print("one-step driver ({}, bf16 state, {}): {} chains x {} "
                  "steps, max|one-step - multi-step| = {:.3e}, {} launches "
                  "of {}, {} of {}".format(
                      type(sampler).__name__, noise_impl, DRIVER_CHAINS,
                      DRIVER_SAMPLES * DRIVER_KEEP, err_driver, one,
                      _record(name + " (bf16)", variant), multi,
                      _record(multi_name + " (bf16)", variant)))
            if one != DRIVER_SAMPLES * DRIVER_KEEP or multi != DRIVER_SAMPLES:
                raise AssertionError("{}: {} and {} launches".format(
                    _record(name + " (bf16)", variant), one, multi))
    # the paired drivers (pair_dots=True, Box-Muller, multi-step only) from
    # these states: B2 paired at bf16 state (the driver's default), then
    # B1 / B5-* paired at f32 state against the unpaired drivers (bit for
    # bit) and at bf16 state; and B3 paired, which no driver reaches, by
    # its wrapper one step at a time on the Philox windows
    launches.update(_paired_drivers(torch, fs, x, y, init_fn, drivers,
                                    sghmc_sampler, device))
    del drivers

    # ---- the lanes drivers vs the fused drivers on the dense network ----
    cost = _fused_cost(torch, apply_fn)
    for method, eps in (("SGHMC", EPS), ("SGLD", EPS_SGLD),
                        *B8_EPS.items()):
        sampler = _sampler(method, eps, cost)
        if method in B8_EPS:
            states = _packed_states(torch, sampler, lanes_states[method],
                                    CHECK_CHAINS)
        else:
            states = _burned_in(torch, x, y, type(sampler), CHECK_CHAINS,
                                device)[1]
        print("lanes vs fused drivers ({}): {} chains x 16 steps, "
              "max|lanes - fused| = {:.3e}".format(
                  type(sampler).__name__, CHECK_CHAINS,
                  _lanes_vs_fused(torch, x, y, sampler, states, eps)))
    del lanes_states

    # ---- the main paths on a small input: card vs plain versions ----
    for configs in (SMALL, SMALL_LANES):
        for method_name, config in configs.items():
            method = Sampler[method_name]
            print("small {} {} main path ({} chains, {} steps) on the card "
                  "vs the CPU: max|diff| = {:.3e}".format(
                      method.value, config["step_impl"], config["n_chains"],
                      config["n_iters"],
                      _small_main_path(torch, x_np, y_np, method, config)))
    _small_main_path(torch, x_np, y_np, Sampler.SGLD,
                     dict(SMALL["SGLD"], stepsize_schedule=EPS), check=False)
    _small_main_path(torch, x_np, y_np, Sampler.PSGLD,
                     dict(SMALL_LANES["SGLD"],
                          stepsize_schedule=B8_EPS["PSGLD"]), check=False)

    # ---- B11 against its plain version: the flagship's ensemble after
    # SVGD_STATE_STEPS steps and the shapes of the JAX package's tests ----
    svgd_x, svgd_g, svgd_h = _svgd_state(torch, x_np, y_np, x, y)
    rng = np.random.default_rng(1)
    cases = [("after {} SVGD steps".format(SVGD_STATE_STEPS), svgd_x, svgd_g,
              svgd_h)]
    for n_p, d in SVGD_SHAPES:
        xs, gs = (torch.as_tensor(rng.normal(size=(n_p, d)).astype(
            np.float32), device=device) for _ in range(2))
        cases.append(("random", xs, gs, pairwise.median_bandwidth(
            pairwise.squared_distance_matrix(xs), n_p)))
    err["B11"] = _svgd_checks(torch, ss, cases)
    svgd_ms, bounds["B11"] = _svgd_times(torch, ss, svgd_x, svgd_g, svgd_h,
                                         card)
    timed.update(svgd_ms)
    del svgd_x, svgd_g, svgd_h, cases
    _svgd_small(torch, x_np, y_np, ss)

    # ---- the main paths: train + predict through the port's BNN ----
    # a kernel's launches are summed over the main paths that run it
    def count(more):
        for name, n_launches in more.items():
            launches[name] = launches.get(name, 0) + n_launches

    rates = {}
    # SGHMC and SGLD on the fused path under the default generator, the
    # CLT's, and under Box-Muller; then the paired kernels (Box-Muller)
    for method, sampling, burnin in (
            ("SGHMC", "B1", "B2"), ("SGLD", "B5-sgld", "B6")):
        fns = {"B1": fs.fused_bnn_multistep,
               "B2": fs.fused_bnn_multistep_burnin,
               "B5-sgld": fs.fused_bnn_multistep_sgld,
               "B6": fs.fused_bnn_multistep_burnin_sgld}
        for variant, kw in (("clt", {}),
                            ("", dict(noise_impl="box_muller")),
                            ("paired", dict(pair_dots=True))):
            count(_flagship(
                torch, x_np, y_np, Sampler[method],
                {_record(name, variant): fns[name]
                 for name in (sampling, burnin)}, card, rates,
                tag="" if variant == "clt" else " " + (variant or
                                                       "box_muller"),
                **kw)[0])
    # pSGLD, relativistic SGHMC and SGNHT: burn-in on discarded steps of
    # the lanes driver (their slim kernel), sampling on B5-* (CLT), at their
    # stepsizes
    slim = _slim_functions(su)
    for method, b8 in SLIM_OF.items():
        b5 = "B5-" + b8[3:]
        count(_flagship(
            torch, x_np, y_np, Sampler[method],
            {b8: slim[b8][0], _record(b5, "clt"): new_fns[b5][0]}, card,
            rates, expected={b8: BURN_IN, _record(b5, "clt"): 1},
            stepsize=B8_EPS[method])[0])
    # the lanes path: one slim launch per step, B9 in burn-in, B7 / B8-sgld
    # in sampling, B8-psgld / B8-rsghmc / B8-sgnht in both
    for method, burn, sample in LANES_FLAGSHIPS:
        expected = {burn: BURN_IN, sample: SAMPLE_STEPS}
        if burn == sample:
            expected = {burn: BURN_IN + SAMPLE_STEPS}
        count(_flagship(
            torch, x_np, y_np, Sampler[method],
            {burn: slim[burn][0], sample: slim[sample][0]}, card, rates,
            step_impl="lanes", network="reference", expected=expected,
            stepsize=B8_EPS.get(method))[0])
    for method in ("SGHMC", "SGLD", *SLIM_OF):
        print("{} flagship update-steps/s, fused{} vs lanes (reference "
              "network): burn-in {:.4e} vs {:.4e}, sampling {:.4e} vs {:.4e} "
              "({})".format(
                  method, " (burn-in on the lanes driver, dense network)"
                  if method in SLIM_OF else "",
                  *(rates[(impl, method, phase)]
                    for phase in ("burn_in", "sampling")
                    for impl in ("fused", "lanes")), card))
    for method in ("SGHMC", "SGLD"):
        print("{} fused flagship, CLT (the default) vs Box-Muller vs paired "
              "(Box-Muller): MSE {:.3e} vs {:.3e} vs {:.3e}; burn-in {:.4e} "
              "vs {:.4e} vs {:.4e}, sampling {:.4e} vs {:.4e} vs {:.4e} "
              "update-steps/s ({})".format(
                  method, *(rates[("fused", method + tag, phase)]
                            for phase in ("mse", "burn_in", "sampling")
                            for tag in ("", " box_muller", " paired")),
                  card))
    # mixed precision, compute_dtype=torch.bfloat16: SGHMC on the fused
    # path (B2 burn-in at f32 state, B1 sampling at bf16 state) and on the
    # lanes path (bf16 gradients into B9-sghmc, then B7 with bf16 state and
    # gradients), then predict's serving rate in f32 and bf16 on the fused
    # flagship's 8192 members
    bf = torch.bfloat16
    more, bnn_bf16 = _flagship(
        torch, x_np, y_np, Sampler.SGHMC,
        {"B1 (bf16, clt)": fs.fused_bnn_multistep,
         "B2 (clt)": fs.fused_bnn_multistep_burnin}, card, rates,
        tag=" bf16", compute_dtype=bf)
    count(more)
    _predict_rates(torch, bnn_bf16, card)
    del bnn_bf16
    # the paired kernels under compute_dtype: B1 paired at bf16 state, its
    # matrix slabs' momentum rounded once per 200-step launch
    count(_flagship(
        torch, x_np, y_np, Sampler.SGHMC,
        {"B1 (bf16, paired)": fs.fused_bnn_multistep,
         "B2 (paired)": fs.fused_bnn_multistep_burnin}, card, rates,
        tag=" bf16 paired", compute_dtype=bf, pair_dots=True)[0])
    print("SGHMC fused flagship, compute_dtype=bfloat16, paired vs CLT: MSE "
          "{:.3e} vs {:.3e}; sampling {:.4e} vs {:.4e} update-steps/s "
          "({})".format(*(rates[("fused", "SGHMC bf16" + tag, phase)]
                          for phase in ("mse", "sampling")
                          for tag in (" paired", "")), card))
    count(_flagship(
        torch, x_np, y_np, Sampler.SGHMC,
        {"B9-sghmc (bf16)": slim["B9-sghmc"][0],
         "B7 (bf16)": slim["B7"][0]}, card, rates, step_impl="lanes",
        network="reference", tag=" bf16", compute_dtype=bf,
        expected={"B9-sghmc (bf16)": BURN_IN, "B7 (bf16)": SAMPLE_STEPS})[0])
    for impl in ("fused", "lanes"):
        print("SGHMC {} flagship, compute_dtype=bfloat16 vs float32: MSE "
              "{:.3e} vs {:.3e}; burn-in {:.4e} vs {:.4e}, sampling {:.4e} "
              "vs {:.4e} update-steps/s ({})".format(
                  impl, rates[(impl, "SGHMC bf16", "mse")],
                  rates[(impl, "SGHMC", "mse")],
                  *(rates[(impl, "SGHMC" + t, phase)]
                    for phase in ("burn_in", "sampling")
                    for t in (" bf16", "")), card))
    # the other samplers' lanes paths under compute_dtype, short runs that
    # drive their bf16 slim instantiations (not gated: 50 + 20 steps)
    for method, burn, sample in LANES_FLAGSHIPS[1:]:
        kernels = {burn + " (bf16)": slim[burn][0],
                   sample + " (bf16)": slim[sample][0]}
        count(_flagship(
            torch, x_np, y_np, Sampler[method], kernels, card, rates,
            step_impl="lanes", network="reference", burn_in=50,
            sample_steps=20, gate=False, tag=" bf16 short",
            stepsize=B8_EPS.get(method), compute_dtype=bf)[0])
    # the wide networks JAX's fused path takes: units=(WIDE_H,) * 3, SGHMC
    # (gated) and SGLD (a short run), their state in device memory (B6's
    # theta and gradient in shared memory); and SGLD (a short run) at
    # units=(DEVICE_H,) * 3, B6's state in device memory
    # (the CLT, the default; and Box-Muller, 200 + 200 steps)
    sghmc_fns = {"B1": fs.fused_bnn_multistep,
                 "B2": fs.fused_bnn_multistep_burnin}
    sgld_fns = {"B5-sgld": fs.fused_bnn_multistep_sgld,
                "B6": fs.fused_bnn_multistep_burnin_sgld}
    for method, kernels, burn_in, sample_steps, gate, variant, h in (
            ("SGHMC", sghmc_fns, BURN_IN, SAMPLE_STEPS, True, "clt", WIDE_H),
            ("SGLD", sgld_fns, 200, 200, False, "clt", WIDE_H),
            ("SGHMC", sghmc_fns, 200, 200, False, "", WIDE_H),
            ("SGLD", sgld_fns, 200, 200, False, "", WIDE_H),
            ("SGLD", {"B6": sgld_fns["B6"]}, 200, 200, False, "clt",
             DEVICE_H),
            ("SGLD", {"B6": sgld_fns["B6"]}, 200, 200, False, "",
             DEVICE_H)):
        tag = " (H={})".format(h)
        more, _ = _flagship(
            torch, x_np, y_np, Sampler[method],
            {_record(name + tag, variant): fn
             for name, fn in kernels.items()}, card, rates,
            chains=WIDE_CHAINS, burn_in=burn_in, sample_steps=sample_steps,
            gate=gate, tag=tag + (" " + variant if variant else
                                  " box_muller"), units=(h,) * 3,
            **({} if variant else dict(noise_impl="box_muller")))
        _placed_as_counted(fs, fs.FusedLayout(1, h, 3),
                           "the H={} flagship".format(h))
        count(more)
    # FusedSGHMC (B10) at the flagship's size, its kernel checks and times
    # from its burned-in state, then the packed (B7 mask) and stacked (B7')
    # drivers from that state (converted to a stacked SGHMCState), and the
    # three SGHMC drivers against each other
    from pysgmcmc_tpu_torch.parallel import (
        sample_chain_packed,
        sample_chain_stacked,
    )

    fused, flat_state, ref_apply, ref_cost, select, launches["B10"], \
        order = _fused_sghmc_flagship(torch, x_np, y_np, x, y, card, rates)
    flat_sampler = SGHMCSampler(ref_cost, stepsize_schedule=EPS,
                                burn_in_steps=BURN_IN,
                                scale_grad=float(N_DATA))
    stacked = _sghmc_states(torch, fused, flat_state, order)
    flat_err, flat_timing = _flat_checks(torch, fused, flat_state,
                                         flat_sampler, stacked, select, card)
    err.update(flat_err)
    flat_ms, flat_bounds = _flat_times(torch, flat_timing, card)
    timed.update(flat_ms)
    bounds.update(flat_bounds)
    del flat_timing, flat_state
    for record, kw in (("B7-mask (bf16)", {}),
                       ("B7-mask", dict(compute_dtype=None))):
        launches[record] = _flat_driver_flagship(
            torch, x_np, y_np, "sample_chain_packed" + (
                " f32" if kw else ""), sample_chain_packed,
            su.slim_sghmc_update, flat_sampler, stacked, select, ref_apply,
            card, rates, **kw)
    for record, bf16_params in (("B7'", False), ("B7' (bf16)", True)):
        launches[record] = _flat_driver_flagship(
            torch, x_np, y_np, "sample_chain_stacked" + (
                " bf16" if bf16_params else ""), sample_chain_stacked,
            su.slim_sghmc_update_tree, flat_sampler, stacked, select,
            ref_apply, card, rates, bf16_params=bf16_params)
    agree, agree_launches = _flat_drivers_agree(torch, flat_sampler,
                                                stacked, select)
    print("packed and stacked vs lanes drivers (SGHMC): {} chains x 16 "
          "steps, max|diff| = {:.3e}; launches of B7 mask (f32 passes) "
          "{}".format(MAIN_CHAINS, agree, agree_launches))
    print("FusedSGHMC flagship update-steps/s: burn-in {:.4e}, sampling "
          "{:.4e}; from its state, sampling: packed (bf16 passes) {:.4e}, "
          "packed (f32 passes) {:.4e}, stacked {:.4e}, stacked bf16_params "
          "{:.4e} ({})".format(
              rates[("flat", "FusedSGHMC", "burn_in")],
              rates[("flat", "FusedSGHMC", "sampling")],
              *(rates[("flat", name, "sampling")] for name in (
                  "sample_chain_packed", "sample_chain_packed f32",
                  "sample_chain_stacked", "sample_chain_stacked bf16")),
              card))
    del fused, stacked, flat_sampler
    torch.cuda.empty_cache()
    # SVGD: the first steps at full size on B11 and on the plain phi, then
    # the flagship (B11's count set to 0 just before)
    _svgd_plain_vs_kernel(torch, x_np, y_np, ss)
    count({"B11": _svgd_flagship(torch, x_np, y_np, ss, card)})
    try:
        _lanes_profile(torch, x, y, card)
    except Exception as exc:  # the trace informs PERF.md; it gates nothing
        print("lanes profile: not measured ({}: {})".format(
            type(exc).__name__, exc))

    replaces = {"B2": ("fused_bnn_multistep_burnin", "fused_step", 2823),
                "B1": ("fused_bnn_multistep", "fused_step", 1007),
                "B6": ("fused_bnn_multistep_burnin_sgld", "fused_step", 2929),
                "B5-sgld": ("fused_bnn_multistep_sgld", "fused_step", 2223),
                "B3": ("fused_bnn_step", "fused_step", 616),
                "B4-sgld": ("fused_bnn_step_sgld", "fused_step", 2002),
                "B9-sghmc": ("slim_sghmc_burnin_update", "slim_update", 995),
                "B7": ("slim_sghmc_update", "slim_update", 331),
                "B9-sgld": ("slim_sgld_burnin_update", "slim_update", 1135),
                "B8-sgld": ("slim_sgld_update", "slim_update", 469),
                "B8-psgld": ("slim_psgld_update", "slim_update", 585),
                "B8-rsghmc": ("slim_rsghmc_update", "slim_update", 713),
                "B8-sgnht": ("slim_sgnht_update", "slim_update", 836),
                "B5-psgld": ("fused_bnn_multistep_psgld", "fused_step", 2351),
                "B5-rsghmc": ("fused_bnn_multistep_rsghmc", "fused_step",
                              2411),
                "B5-sgnht": ("fused_bnn_multistep_sgnht", "fused_step", 2283),
                "B4-psgld": ("fused_bnn_step_psgld", "fused_step", 2054),
                "B4-rsghmc": ("fused_bnn_step_rsghmc", "fused_step", 2168),
                "B4-sgnht": ("fused_bnn_step_sgnht", "fused_step", 2106),
                "B11": ("svgd_phi_streaming", "svgd_streaming", 99),
                "B10": ("fused_sghmc_update", "fused_update", 169),
                "B7-mask": ("slim_sghmc_update (mask)", "slim_update", 331),
                "B7'": ("slim_sghmc_update_tree", "slim_update", 269)}
    # the bf16-state instantiations and the wide (device-memory) kernels,
    # each its own record
    variants = [name + " (bf16)" for name in (
        "B2", "B1", "B3", "B4-sgld", "B5-sgld", "B4-sgnht", "B4-rsghmc",
        "B5-sgnht", "B5-rsghmc", *SLIM)]
    variants += [name + " (H={})".format(WIDE_H)
                 for name in ("B2", "B1", "B6", "B5-sgld")]
    variants += ["B6 (H={})".format(DEVICE_H)]
    variants += ["B7-mask (bf16)", "B7' (bf16)"]
    # every fused record again as the CLT instantiation, and those of the
    # paired kernels (f32, and bf16 where the kernel has a momentum) as the
    # paired one
    fused = [name for name in [*replaces, *variants]
             if replaces[name.split(" ")[0]][1] == "fused_step"]
    variants += [_record(name, "clt") for name in fused]
    variants += [_record(name, "paired") for name in fused
                 if name.split(" ")[0] in PAIRED_KERNELS and "H=" not in name
                 and name not in ("B5-sgld (bf16)",)]

    def source(name, module):
        if "clt" in name:
            return "fused_step_clt", "fused_step", CLT_LINE
        if "paired" in name:
            return ("fused_step_paired", "fused_step",
                    PAIRED_LINES[name.split(" ")[0]])
        return ("slim_update" if module == "fused_update" else module,
                module, None)

    records = [
        {"name": fn_name + name[len(name.split(" ")[0]):], "route": "cuda",
         "source": "pysgmcmc_tpu_torch/csrc/{}.cu".format(src),
         "replaces": "pysgmcmc_tpu/ops/{}.py:{}".format(
             tpu_module, tpu_line or line),
         "launches": launches[name], "max_abs_err": err[name],
         "ms": timed[name], "plain_ms": timed[name + " plain"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name in [*replaces, *variants]
        for fn_name, module, line in [replaces[name.split(" ")[0]]]
        for src, tpu_module, tpu_line in [source(name, module)]]
    for r in records:  # B11's tensor-core bound beside its f32 one
        if r["name"] == replaces["B11"][0]:
            r["bound_tf32_ms"] = _svgd_tf32_bound(SVGD_PARTICLES, P)
    idle = [r["name"] for r in records if r["launches"] < 1]
    if idle:
        raise AssertionError("kernels not launched on a main path: "
                             "{}".format(idle))
    print("chip_smoke wall time: {:.1f} s ({})".format(
        time.perf_counter() - wall_start, card))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
