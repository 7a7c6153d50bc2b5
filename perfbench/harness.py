"""The benchmark of ``pysgmcmc_tpu_torch``: one run of one cell.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``perfbench/configs/<name>.json``, the mix
``perfbench/traffic/<name>.json``, whose ``mode`` names the code that drives
it (``perfbench/modes/<mode>.py``).  A run sets up the cell, measures for
``--seconds`` (profiled with ``--trace 1``), reads the device's peak
memory, checks that no JAX module was loaded, checks what the window
produced against the plain reference (``perfbench/limits/<cell>.json`` holds
each number's limit), and prints one JSON line: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics, each read by
``perfbench/metrics/<name>.py`` (``--trace 1``).

``--control 1`` puts the reference computed at TF32 in the program's place
in the check; the benchmark's own runs never pass it.
"""

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from perfbench import roofline, shared
from perfbench.reference import bnn as ref_bnn
from perfbench.trace import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pysgmcmc_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    """The loaded modules whose top-level name is a JAX package or the JAX
    package of this repository (whole names: ``pysgmcmc_tpu_torch`` is
    not ``pysgmcmc_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _cell_entry(bench, workload):
    for entry in bench["workloads"]:
        if entry["name"] == workload:
            return entry
    raise SystemExit("perfbench: no workload {!r} in BENCHMARK.json".format(
        workload))


def cell_metrics(bench, workload):
    """The end-to-end and the per-layer metrics that ``workload`` reports."""
    def listed(metric):
        return workload in metric.get("workloads", [workload])

    end_to_end = [m for m in bench["end_to_end"] if listed(m)]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return end_to_end, per_layer


def reader(name):
    """The ``read(run)`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What a per-layer reader sees: the cell (its configuration, traffic
    and counts), the trace, the chip's peaks."""

    def __init__(self, cell, trace, peaks):
        self.cell = cell
        self.trace = trace
        self.peaks = peaks
        self.counts = cell.counts


def make_cell(bench, workload, seed, device, tracing, overrides=None):
    """The cell object of ``workload`` (its mode's ``Cell``), with optional
    ``overrides`` of configuration and traffic keys (the tests' sizes)."""
    entry = _cell_entry(bench, workload)
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT, configs[entry["config"]]["file"])
    traffic = load_json(HERE, "traffic", entry["traffic"] + ".json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    mode = importlib.import_module("perfbench.modes." + traffic["mode"])
    return mode.Cell(config, traffic, seed, device, shared.Spans(tracing))


def judge(numbers, limits):
    """``(correct, checks)``: every limited number present, finite and at
    most its limit."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def run_cell(workload, seed, seconds, trace=False, control=False,
             device="cuda", overrides=None, started=None, bench=None):
    """One run; returns the result's dictionary (the JSON line's)."""
    started = time.perf_counter() if started is None else started
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    end_to_end, per_layer = cell_metrics(bench, workload)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = make_cell(bench, workload, seed, device, trace, overrides)
    cell.setup()
    profiler = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    setup_s = time.perf_counter() - started
    with cell.spans("window"):
        values, attempted = cell.window(seconds)
    traced = None
    if profiler is not None:
        profiler.stop()
        traced = Trace(profiler.profiler.kineto_results.events())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated()
                   if cuda else 0}
    cell.release()
    if cuda:
        ref_bnn.strict_float32()
    with torch.no_grad():
        numbers = cell.check(control=control)
    correct, checks = judge(numbers, load_json(HERE, "limits",
                                               workload + ".json"))
    result = {"correct": correct, "attempted": attempted, "failed": 0}
    metrics = {}
    if trace:
        run = Run(cell, traced, roofline.peaks(device_info["kind"]))
        for metric in per_layer:
            value = reader(metric["name"])(run)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
    else:
        values["setup_s"] = setup_s
        for metric in end_to_end:
            metrics[metric["name"]] = {"value": values[metric["name"]],
                                       "unit": metric["unit"]}
    result.update(metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def main(argv, started):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one host thread for PyTorch's own CPU work: on a shared host the
    # window's rate then moves less with the neighbours' load
    torch.set_num_threads(1)
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = _cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("perfbench: {} needs {} CUDA device(s); found {}".format(
            args.workload, chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      trace=bool(args.trace), control=bool(args.control),
                      started=started, bench=bench)
    found = forbidden_modules()
    if found:
        print("perfbench: loaded forbidden modules: {}".format(
            ", ".join(found)), file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print("check {} {!r} limit {!r}".format(name, check["value"],
                                                check["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
