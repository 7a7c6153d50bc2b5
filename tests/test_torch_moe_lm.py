"""The port's DeepSeek-V3 decoder (``models/moe_transformer.py``) and its
Bayesian language model against the plain reference
``tests/torch_reference/moe_transformer.py``, on the CPU at a tiny preset:
hidden 64, 2 heads, kv rank 16, rope dim 8, 8 routed experts of which 4 are
held, top-2, a vocabulary of 128, sequences of 16.

- logits, cost and gradient on seeded weights, with a zero and a nonzero
  correction bias;
- the share of expert parallelism: the expert layer's outputs with each of
  two disjoint sets of held experts, the shared experts counted once, add
  up to the uncut reference layer;
- dropless routing when every token picks the same expert;
- ``BayesianLanguageModel``'s train and predict through the lanes drivers'
  plain kernels, and the spans and counter of a traced step.
"""

import pytest
import torch

from pysgmcmc_tpu_torch.models import moe_transformer as mt
from pysgmcmc_tpu_torch.models.bayesian_language_model import (
    BayesianLanguageModel,
)
from pysgmcmc_tpu_torch.utils import tracing
from tests.torch_reference import moe_transformer as ref

TINY = dict(mt.MOONLIGHT_16B_A3B, hidden_size=64, num_attention_heads=2,
            kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, vocab_size=128,
            num_hidden_layers=3)
HELD = [1, 2, 5, 6]
LENGTH = 16


def _tokens(n, seed=0):
    return torch.randint(0, TINY["vocab_size"], (n, LENGTH + 1),
                         generator=torch.Generator().manual_seed(seed))


def _bias(nonzero):
    bias = torch.zeros(TINY["num_hidden_layers"] - 1,
                       TINY["n_routed_experts"])
    if nonzero:
        bias.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(3))
    return bias


@pytest.mark.parametrize("nonzero_bias", [False, True],
                         ids=["zero_bias", "bias"])
def test_logits_cost_and_gradient_match_the_reference(nonzero_bias):
    bias = _bias(nonzero_bias)
    init, apply = mt.moe_transformer(TINY, held_experts=HELD,
                                     correction_bias=bias, device="cpu")
    params = init(torch.Generator().manual_seed(1))
    for name in params:  # norms away from 1, to reach their gradients
        if name.endswith("norm"):
            params[name] = params[name] + 0.1 * torch.randn(
                params[name].shape, generator=torch.Generator().manual_seed(2))
    corpus = _tokens(3)
    tokens, targets = corpus[:, :-1], corpus[:, 1:]
    torch.testing.assert_close(
        apply(params, tokens), ref.logits(params, tokens, TINY, HELD, bias),
        rtol=1e-5, atol=1e-5)

    def grads(cost_fn):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        cost = cost_fn(leaves)
        return cost, torch.autograd.grad(cost, list(leaves.values()))

    n = 1000.0
    cost, got = grads(lambda p: n * torch.nn.functional.cross_entropy(
        apply(p, tokens).reshape(-1, TINY["vocab_size"]), targets.reshape(-1)))
    want_cost, want = grads(lambda p: ref.cost(p, tokens, targets, n, TINY,
                                               HELD, bias))
    torch.testing.assert_close(cost, want_cost, rtol=1e-6, atol=0.0)
    for name, g, w in zip(params, got, want):
        assert float(w.norm()) > 0.0, name
        assert float((g - w).norm() / w.norm()) < 1e-4, name


def _layer_params(held, full):
    """An expert layer's parameters holding ``held``, cut from ``full``
    (which holds every expert)."""
    out = dict(full)
    for part in ("experts_gate", "experts_up", "experts_down"):
        out["l1." + part] = full["l1." + part][held]
    return out


def test_expert_shares_add_up_to_the_whole_layer():
    every = list(range(TINY["n_routed_experts"]))
    init, _ = mt.moe_transformer(TINY, device="cpu")
    full = init(torch.Generator().manual_seed(4))
    x = torch.randn(2, LENGTH, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    bias = _bias(True)[0]
    whole = ref.routed(full, "l1.", x, TINY, every, bias) \
        + ref.shared(full, "l1.", x)
    parts = [mt.moe_ffn(_layer_params(held, full), "l1.", x, TINY,
                        mt.held_map(held, len(every), "cpu"), bias)
             for held in (HELD, [e for e in every if e not in HELD])]
    shared = ref.shared(full, "l1.", x)
    torch.testing.assert_close(parts[0] + parts[1] - shared, whole,
                               rtol=1e-5, atol=1e-5)
    # each share alone leaves the other share's experts out
    assert float((parts[0] - whole).abs().max()) > 1e-3


def test_routing_is_dropless_when_every_token_picks_one_expert():
    bias = torch.zeros(TINY["n_routed_experts"])
    bias[HELD[0]] = 10.0  # every token's first choice
    init, _ = mt.moe_transformer(TINY, held_experts=HELD, device="cpu")
    params = init(torch.Generator().manual_seed(6))
    x = torch.randn(3 * LENGTH, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(7))
    held = mt.held_map(HELD, TINY["n_routed_experts"], "cpu")
    idx, _, tokens, counts, xs = mt.route(
        x, params["l1.router"], bias, held, TINY["num_experts_per_tok"],
        TINY["routed_scaling_factor"], True)
    assert bool((idx == HELD[0]).any(dim=-1).all())
    assert int(counts[0]) == x.shape[0]  # no token dropped
    assert int(counts.sum()) == tokens.numel() == xs.shape[0]
    got = mt.moe_ffn(params, "l1.", x, TINY, held, bias)
    want = ref.routed(params, "l1.", x, TINY, HELD, bias) \
        + ref.shared(params, "l1.", x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _model(**kwargs):
    net = mt.moe_transformer(TINY, held_experts=HELD, device="cpu")
    return BayesianLanguageModel(net, batch_size=2, burn_in_steps=3,
                                 n_nets=3, sample_steps=2, seed=11,
                                 device="cpu", **kwargs)


def test_train_and_predict_through_the_lanes_drivers():
    corpus = _tokens(10, seed=8)
    model = _model()
    model.train(corpus[:, :-1], corpus[:, 1:])
    first = {k: v[0] for k, v in model.samples.items()}
    assert all(v.shape[0] == 3 for v in model.samples.values())
    assert all(bool(torch.isfinite(v).all()) for v in model.samples.values())
    init, _ = mt.moe_transformer(TINY, held_experts=HELD, device="cpu")
    start = init(torch.Generator().manual_seed(11))
    assert any(not torch.equal(first[k], start[k]) for k in start)
    assert any(not torch.equal(first[k], model.samples[k][1])
               for k in first)
    mean, var = model.predict(corpus[:4, :-1])
    assert mean.shape == var.shape == (4, LENGTH, TINY["vocab_size"])
    torch.testing.assert_close(mean.sum(-1), torch.ones(4, LENGTH))
    assert bool((var >= 0).all()) and float(var.max()) > 0.0
    # the same seed gives the same samples
    again = _model()
    again.train(corpus[:, :-1], corpus[:, 1:])
    assert all(torch.equal(v, again.samples[k])
               for k, v in model.samples.items())


def test_a_traced_step_spans_both_passes_and_counts_held_assignments():
    corpus = _tokens(10, seed=9)
    model = _model()
    states = model.start(corpus[:, :-1], corpus[:, 1:])
    tracing.counts.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.sample(states, 1, keep_every=1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for span, per_step in (("mla.attention", 2 * 3), ("moe.route", 2 * 2),
                           ("moe.experts", 2 * 2), ("moe.shared", 2 * 2),
                           ("lanes.gradient", 1), ("lanes.update", 1),
                           ("lanes.sample", 1)):
        assert names.count(tracing.PREFIX + span) == per_step, span
    assigned = tracing.counts["moe.held_assignments"]
    assert 0 < assigned <= 2 * LENGTH * 2 * TINY["num_experts_per_tok"]


def test_refusals():
    with pytest.raises(ValueError, match="q_lora_rank"):
        mt.moe_transformer(dict(TINY, q_lora_rank=32), device="cpu")
    with pytest.raises(ValueError, match="held_experts"):
        mt.moe_transformer(TINY, held_experts=[1, 1], device="cpu")
    with pytest.raises(ValueError, match="integer token"):
        _model().start(torch.zeros(4, LENGTH), torch.zeros(4, LENGTH))
    with pytest.raises(ValueError, match="trained"):
        _model().predict(torch.zeros(1, LENGTH, dtype=torch.int64))
