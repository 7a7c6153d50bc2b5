"""The port's spans (``pysgmcmc_tpu_torch.utils.tracing``): free with no
profiler, and under one each path emits its spans nested as documented.

Each case runs its path at a tiny size on the CPU: a fused burn-in and
sampling call, one streaming and one dense SVGD step, a fused BNN train and
predict, and a BNN SVGD train.  The spans are read from the profiler's raw
events, as the benchmark's trace reads them.
"""

import numpy as np
import pytest
import torch

from pysgmcmc_tpu_torch.models import BayesianNeuralNetwork, dense_network
from pysgmcmc_tpu_torch.data_batches import batch_fn
from pysgmcmc_tpu_torch.parallel import (
    burnin_chain_fused,
    burnin_chain_lanes,
    sample_chain_fused,
    sample_chain_lanes,
)
from pysgmcmc_tpu_torch.samplers import SGHMCSampler
from pysgmcmc_tpu_torch.samplers.svgd import SVGDSampler
from pysgmcmc_tpu_torch.sampling import Sampler
from pysgmcmc_tpu_torch.utils import tracing

BNN = dict(network="dense", units=(6, 6), n_chains=2, n_nets=2,
           burn_in_steps=4, sample_steps=2, n_iters=6, log_every=None,
           device="cpu")


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (40, 1))
    return x, np.sinc(x[:, 0] * 10 - 5)


def _fused_drivers():
    x, y = _data()
    init, _ = dense_network(1, units=(6, 6), device="cpu")
    sampler = SGHMCSampler(lambda p, b: None, stepsize_schedule=0.01,
                           scale_grad=40.0, gaussian_prior_scale=1e-3)
    gen = torch.Generator().manual_seed(0)
    burned = burnin_chain_fused(sampler, sampler.init(init(gen, (3,))), gen,
                                3, x, y)
    sample_chain_fused(sampler, burned, gen, 2, x, y, keep_every=2,
                       multistep=True)


def _svgd_step(kernel_impl):
    def run():
        kw = dict(streaming_interpret=True, streaming_tile=4) \
            if kernel_impl == "streaming" else {}
        sampler = SVGDSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
                              kernel_impl=kernel_impl, **kw)
        particles = {"x": torch.randn(
            8, 3, generator=torch.Generator().manual_seed(1))}
        sampler.step(sampler.init(particles), torch.Generator())
    return run


def _lanes_drivers():
    init, apply = dense_network(1, units=(6, 6), device="cpu")
    sampler = SGHMCSampler(
        lambda p, b: torch.sum((apply(p, b[0])[:, 0] - b[1][:, 0]) ** 2),
        stepsize_schedule=0.01, scale_grad=40.0)
    x, y = _data()
    select = batch_fn(x, y, 8)
    gen = torch.Generator().manual_seed(0)
    for n_chains in (2, 1):  # vmapped, and one chain's plain autograd
        burned = burnin_chain_lanes(
            sampler, sampler.init(init(gen, (n_chains,))), gen, 2,
            batch_fn=select, compute_dtype=None)
        sample_chain_lanes(sampler, burned, gen, 1, batch_fn=select,
                           keep_every=2, compute_dtype=None)


def _bnn_fused():
    x, y = _data()
    model = BayesianNeuralNetwork(step_impl="fused", seed=3, **BNN)
    model.train(x, y)
    model.predict(x[:5])


def _bnn_svgd():
    x, y = _data()
    BayesianNeuralNetwork(sampling_method=Sampler.SVGD,
                          kernel_impl="streaming", seed=3,
                          streaming_interpret=True, **BNN).train(x, y)


# case -> (run, its spans as (span, the span it lies inside or None))
CASES = {
    "fused_drivers": (_fused_drivers, [
        ("fused.burn_in", None), ("fused.sample", None)]),
    "lanes_drivers": (_lanes_drivers, [
        ("lanes.burn_in", None), ("lanes.sample", None),
        ("lanes.gradient", "lanes.burn_in"),
        ("lanes.gradient", "lanes.sample"),
        ("lanes.update", "lanes.burn_in"), ("lanes.update", "lanes.sample")]),
    "svgd_streaming": (_svgd_step("streaming"), [
        ("svgd.step", None), ("svgd.gradient", "svgd.step"),
        ("svgd.bandwidth", "svgd.step"), ("svgd.transport", "svgd.step"),
        ("svgd.update", "svgd.step")]),
    "svgd_dense": (_svgd_step("dense"), [
        ("svgd.step", None), ("svgd.gradient", "svgd.step"),
        ("svgd.transport", "svgd.step"), ("svgd.update", "svgd.step")]),
    "bnn_fused": (_bnn_fused, [
        ("bnn.burn_in", None), ("bnn.sampling", None),
        ("fused.burn_in", "bnn.burn_in"), ("fused.sample", "bnn.sampling"),
        ("bnn.predict", None), ("predict.to_host", "bnn.predict")]),
    "bnn_svgd": (_bnn_svgd, [
        ("bnn.transport", None), ("svgd.step", "bnn.transport"),
        ("svgd.gradient", "svgd.step"), ("svgd.bandwidth", "svgd.step"),
        ("svgd.transport", "svgd.step"), ("svgd.update", "svgd.step")]),
}
SVGD_PHASES = ("svgd.gradient", "svgd.bandwidth", "svgd.transport",
               "svgd.update")


def _recorded(run):
    """``{span: [(start_ns, end_ns), ...]}`` of the program's spans that a
    CPU profiler records around ``run()``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(tracing.PREFIX):
            spans.setdefault(name[len(tracing.PREFIX):], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return {name: sorted(times) for name, times in spans.items()}


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_never_enters_it(case, monkeypatch):
    """With no profiler recording, no span reaches ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    assert not torch.autograd._profiler_enabled()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("a") is tracing.span("b")
    CASES[case][0]()


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_as_documented(case):
    """Under a CPU profiler each case emits exactly its spans, every one
    inside the span the table puts it in."""
    run, table = CASES[case]
    spans = _recorded(run)
    assert set(spans) == {name for name, _ in table}
    parents = {}
    for name, parent in table:
        if parent is not None:
            parents.setdefault(name, []).append(parent)
    for name, names in parents.items():
        outer = [span for parent in names for span in spans[parent]]
        assert all(any(_inside(child, span) for span in outer)
                   for child in spans[name]), name
        for parent in names:  # and every parent holds one
            assert all(any(_inside(child, span) for child in spans[name])
                       for span in spans[parent]), (name, parent)


@pytest.mark.parametrize("case", ["svgd_streaming", "svgd_dense",
                                  "bnn_svgd"])
def test_svgd_phases_tile_the_step(case):
    """The SVGD phases lie inside ``svgd.step``, one of each a step, one
    after another and never overlapping."""
    spans = _recorded(CASES[case][0])
    phases = [p for p in SVGD_PHASES if p in spans]
    assert len(phases) == (4 if "svgd.bandwidth" in spans else 3)
    for step in spans["svgd.step"]:
        inside = sorted((s, e, name) for name in phases
                        for s, e in spans[name] if _inside((s, e), step))
        assert [name for _, _, name in inside] == phases
        for (_, end, _), (start, _, _) in zip(inside, inside[1:]):
            assert end <= start


def test_traced_spans_both_passes_and_counts_only_while_recording():
    """``traced`` gives the plain call's value and gradient, and under a
    profiler a span of its name in the forward and in the backward pass;
    ``count`` adds only while a profiler records."""
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))

    def fn(x, w):
        return torch.tanh(x @ w), (x @ w).argmax(-1)

    def run():
        leaf = w.clone().requires_grad_()
        y, idx = tracing.traced("example", fn, x, leaf)
        tracing.count("example", 3)
        (y.sum() + 0 * idx.sum()).backward()
        return y.detach(), leaf.grad

    tracing.counts.clear()
    plain_y, plain_grad = run()
    assert tracing.counts == {}
    traced = []
    spans = _recorded(lambda: traced.append(run()))
    assert len(spans["example"]) == 2  # forward, then backward
    assert spans["example"][0][1] <= spans["example"][1][0]
    assert tracing.counts == {"example": 3}
    assert torch.equal(traced[0][0], plain_y)
    assert torch.equal(traced[0][1], plain_grad)
