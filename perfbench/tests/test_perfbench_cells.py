"""Every cell driven end to end on the CPU at a tiny size (the port's plain
versions stand in for its kernels): the sound program comes out correct,
and the control and each fault the cell can have come out not correct.
A run on the card is refused without one."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from pysgmcmc_tpu_torch.models import bayesian_neural_network as bnn_module
from pysgmcmc_tpu_torch.models.bayesian_neural_network import (
    BayesianNeuralNetwork,
)
from pysgmcmc_tpu_torch.parallel import packed
from pysgmcmc_tpu_torch.samplers.svgd import SVGDSampler

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 11
TINY = {
    "sghmc3x50-train": {
        "config": {"n_chains": 6},
        "traffic": {"burn_in_steps": 96, "log_every": 48, "sample_steps": 48,
                    "check_chains": 6}},
    "sghmc3x50-sample": {
        "config": {"n_chains": 8},
        "traffic": {"burn_in_steps": 1024, "check_chains": 8}},
    "svgd3x50-transport": {
        "config": {"n_particles": 8},
        "traffic": {"check_from": 2}},
}
CELLS = sorted(TINY)


def run(cell, control=False, trace=False):
    return harness.run_cell(cell, SEED, 0.01, trace=trace, control=control,
                            device="cpu", overrides=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {
        m["name"] for m in harness.cell_metrics(
            harness.load_json(ROOT, "BENCHMARK.json"), cell)[0]}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics_only(cell):
    result = run(cell, trace=True)
    assert result["correct"], result["checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_json(ROOT, "BENCHMARK.json"), cell)[1]}
    assert set(result["metrics"]) <= names


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert not run(cell, control=True)["correct"]


def _quarter(new, old):
    """``new`` with its last quarter of rows (rounded up) from ``old``."""
    n = new.shape[0]
    new = new.clone()
    new[n - -(-n // 4):] = old[n - -(-n // 4):].to(new.dtype)
    return new


def _fused_fault(monkeypatch, fault):
    burn, sample = packed.fused_bnn_multistep_burnin, \
        packed._FUSED_KERNELS["sghmc"][0]

    def burn_fault(theta, v, tau, g, v_hat, x_win, y_win, *args, **kw):
        if fault == "half_batch":
            half = x_win.shape[1] // 2
            kw["batch_size"] = half
            x_win, y_win = x_win[:, :half].contiguous(), \
                y_win[:, :half].contiguous()
        out = burn(theta, v, tau, g, v_hat, x_win, y_win, *args, **kw)
        if fault == "unchanged":
            return (theta, v, tau, g, v_hat) + tuple(out[5:])
        if fault == "quarter":
            return tuple(_quarter(a, b) for a, b in zip(
                out[:5], (theta, v, tau, g, v_hat))) + tuple(out[5:])
        return out

    def sample_fault(theta, v, minv, x_win, y_win, *args, **kw):
        if fault == "half_batch":
            half = x_win.shape[1] // 2
            kw["batch_size"] = half
            x_win, y_win = x_win[:, :half].contiguous(), \
                y_win[:, :half].contiguous()
        out = list(sample(theta, v, minv, x_win, y_win, *args, **kw))
        if fault == "unchanged":
            out[:2] = theta, v
        if fault == "quarter":
            out[:2] = _quarter(out[0], theta), _quarter(out[1], v)
        if fault == "altered":  # one weight of every chain's answer
            out[0] = out[0].clone()
            out[0][:, 100] += 0.1 * out[0].abs().amax(dim=1)
        return tuple(out)

    monkeypatch.setattr(packed, "fused_bnn_multistep_burnin", burn_fault)
    monkeypatch.setitem(packed._FUSED_KERNELS, "sghmc",
                        (sample_fault, packed._FUSED_KERNELS["sghmc"][1]))
    if fault == "stale":
        _stale_fault(monkeypatch)


def _stale_fault(monkeypatch):
    """The sampling driver hands back the state it was given, with the
    positions it sampled; the model hands each burn-in chunk after the
    first the state the chunk before was handed."""
    sample_chain = packed.sample_chain_fused

    def stale_sample(sampler, states, *args, **kwargs):
        _, positions, costs = sample_chain(sampler, states, *args, **kwargs)
        return states, positions, costs

    for module in (packed, bnn_module):
        monkeypatch.setattr(module, "sample_chain_fused", stale_sample)
    fused_path = BayesianNeuralNetwork._fused_path

    def stale_path(self, *args, **kwargs):
        sampler, burn, sample = fused_path(self, *args, **kwargs)
        handed = []

        def stale_burn(states, n_steps):
            handed.append(states)
            return burn(handed[max(0, len(handed) - 2)], n_steps)
        return sampler, stale_burn, sample

    monkeypatch.setattr(BayesianNeuralNetwork, "_fused_path", stale_path)


def _svgd_fault(monkeypatch, fault):
    step = SVGDSampler.step

    def faulty(self, state, key, batch=None, phase=None):
        if fault == "half_batch":
            half = batch[0].shape[0] // 2
            batch = tuple(torch.cat([b[:half], b[:half]]) for b in batch)
        new, info = step(self, state, key, batch, phase)
        if fault == "unchanged":
            return state, info
        if fault == "quarter":  # a quarter of the particles left as they were
            new = new._replace(**{field: {
                k: _quarter(leaf, getattr(state, field)[k])
                for k, leaf in getattr(new, field).items()}
                for field in ("position", "historical_grad")})
        if fault == "altered":  # one weight of every particle
            w = new.position["w2"].clone()
            w[:, 3, 4] += 0.1 * w.abs().amax(dim=(1, 2))
            new = new._replace(position=dict(new.position, w2=w))
        return new, info

    monkeypatch.setattr(SVGDSampler, "step", faulty)


FUSED_FAULTS = ("unchanged", "half_batch", "altered", "quarter", "stale")
FAULTS = [(cell, fault) for cell in CELLS for fault in FUSED_FAULTS
          if not (cell == "svgd3x50-transport" and fault == "stale")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    if cell == "svgd3x50-transport":
        _svgd_fault(monkeypatch, fault)
    else:
        _fused_fault(monkeypatch, fault)
    result = run(cell)
    assert not result["correct"], result["checks"]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "pysgmcmc_tpu_torch.fake", object())
    assert harness.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla", "pysgmcmc_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == ["flax", "jax", "jaxlib",
                                           "pysgmcmc_tpu"]


def test_a_run_without_a_card_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "sghmc3x50-train", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    result = harness.run_cell(cell, SEED, 2.0, control=True, bench=bench)
    assert not result["correct"], json.dumps(result["checks"])
