"""The ``moonlight-ep8-sample`` cell driven end to end on the CPU at a tiny
size (the slim kernels' plain versions, every width of the configuration
cut, the deployment's shape kept): the sound program comes out correct, its
traced run reports the cell's per-layer metrics that a CPU run can read,
and the control and each fault of the network or of B7's inputs come out
not correct."""

import pytest
import torch

from perfbench import harness
from pysgmcmc_tpu_torch.models import moe_transformer as mt
from pysgmcmc_tpu_torch.parallel import packed

SEED = 2**31 + 11
CELL = "moonlight-ep8-sample"
TINY = {
    "config": dict(hidden_size=64, num_attention_heads=2, kv_lora_rank=16,
                   qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
                   intermediate_size=96, moe_intermediate_size=32,
                   router_experts=8, n_routed_experts=4,
                   held_experts=[0, 1, 2, 3], num_experts_per_tok=2,
                   vocab_size=128, num_hidden_layers=3, sequence_length=16,
                   n_sequences=64, batch_size=4),
    "traffic": dict(burn_in_steps=2, n_samples=2, keep_every=2,
                    balance_sequences=8, check_calls=1, check_elements=16)}


def run(control=False, trace=False):
    return harness.run_cell(CELL, SEED, 0.01, trace=trace, control=control,
                            device="cpu", overrides=TINY)


def test_sound_program_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"sample_rate", "setup_s"}
    assert set(result["checks"]) == {"link_gap", "rule_gap", "route_gap",
                                     "cost_gap", "grad_gap"}


def test_traced_run_reads_the_counter():
    result = run(trace=True)
    assert result["correct"], result["checks"]
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_json(harness.ROOT, "BENCHMARK.json"), CELL)[1]}
    assert set(result["metrics"]) <= names


def test_control_is_not_correct():
    assert not run(control=True)["correct"]


def _no_shared(monkeypatch):
    monkeypatch.setattr(mt, "shared_experts",
                        lambda x, *weights: torch.zeros_like(x))


def _absent_as_held(monkeypatch):
    route = mt.route

    def every_expert_held(x, router, bias, held, *args):
        n_held = int((held >= 0).sum())
        return route(x, router, bias, torch.arange(
            held.numel(), device=held.device) % n_held, *args)

    monkeypatch.setattr(mt, "route", every_expert_held)


def _no_rope(monkeypatch):
    monkeypatch.setattr(mt, "rope", lambda x, cos, sin: x)


def _no_gradient(monkeypatch):
    # B7 handed a zero gradient: the tap still sees the one the program
    # passed, as the kernel's inputs
    update = packed.slim_sghmc_update

    def without_gradient(theta, v, grad, *args, **kwargs):
        return update(theta, v, torch.zeros_like(grad), *args, **kwargs)

    monkeypatch.setattr(packed, "slim_sghmc_update", without_gradient)


@pytest.mark.parametrize(
    "fault", [_no_shared, _absent_as_held, _no_rope, _no_gradient],
    ids=["no_shared", "absent_as_held", "no_rope", "no_gradient"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run()
    assert not result["correct"], result["checks"]
