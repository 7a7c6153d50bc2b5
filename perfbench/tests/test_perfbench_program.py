"""The readers of the program's spans (``perfbench/program.py`` and the six
metrics that use it) against hand counts on a synthetic trace: hand-made
host spans and launches, and device operations, on one clock in
nanoseconds.  Each reader returns ``None`` with no trace, on a CPU run and
on a program that records no spans."""

import types

import pytest
import torch

from perfbench import harness, program
from perfbench.trace import Trace
from pysgmcmc_tpu_torch.samplers.svgd import SVGDSampler


class Event:
    """What ``Trace`` reads of one of the profiler's raw events."""

    def __init__(self, name, start, end, cuda=False, corr=0):
        self._name, self._start, self._end = name, start, end
        self._cuda, self._corr = cuda, corr

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._cuda and self._name.startswith("pysgmcmc.")


def _events(spans, ops):
    """``spans`` as ``(name, start, end)`` (program spans get the prefix),
    ``ops`` as ``(launch, start, end)`` or ``(launch, start, end, name)``:
    each launched by its own ``cudaLaunchKernel``; the window [0, 1000]."""
    events = [Event("perfbench.window", 0, 1000)]
    for name, start, end in spans:
        events.append(Event("pysgmcmc." + name, start, end))
    for corr, (launch, start, end, *name) in enumerate(ops, 1):
        events.append(Event("cudaLaunchKernel", launch, launch + 2,
                            corr=corr))
        events.append(Event(name[0] if name else "kernel_{}".format(corr),
                            start, end, cuda=True, corr=corr))
    return events


# two SVGD steps, each tiled by its four phases; a span outside the window
SVGD_SPANS = [
    ("svgd.step", 100, 400), ("svgd.gradient", 100, 200),
    ("svgd.bandwidth", 200, 250), ("svgd.transport", 250, 350),
    ("svgd.update", 350, 400),
    ("svgd.step", 500, 800), ("svgd.gradient", 500, 640),
    ("svgd.bandwidth", 640, 700), ("svgd.transport", 700, 780),
    ("svgd.update", 780, 800),
    ("svgd.step", 1100, 1200), ("svgd.update", 1150, 1200),
]
SVGD_OPS = [
    (110, 120, 150),   # gradient
    (210, 215, 240), (220, 240, 262),   # bandwidth, the second into B11's
    (260, 262, 345),   # transport
    (360, 370, 380),   # update
    (520, 600, 650),   # gradient, running on into the bandwidth
    (650, 660, 690),   # bandwidth
    (710, 710, 790),   # transport, running on into the update
]
# the sampling driver: two calls, each with copies before its first fused
# kernel and one after it; a third that launches none; a burn-in call,
# which the sampling reader leaves out
SAMPLE_SPANS = [
    ("fused.sample", 100, 400), ("fused.sample", 500, 900),
    ("fused.sample", 905, 915), ("fused.burn_in", 920, 990),
]
SAMPLE_OPS = [(90, 95, 130, "copy"), (120, 125, 128, "copy"),
              (165, 170, 390, "fused_kernel<0>"),
              (200, 390, 395, "fused_kernel<0>"), (505, 510, 515, "copy"),
              (535, 540, 890, "fused_kernel<1>"),
              (955, 960, 985, "fused_kernel<2>")]
# the model's burn-in: two chunks inside ``bnn.burn_in``, the second
# waiting on the first's kernel; a driver call outside it, left out
BURNIN_SPANS = [
    ("bnn.burn_in", 100, 500), ("fused.burn_in", 110, 300),
    ("fused.burn_in", 300, 480), ("fused.burn_in", 600, 700),
]
BURNIN_OPS = [(150, 150, 310, "fused_kernel<2>"), (305, 310, 314, "copy"),
              (320, 330, 470, "fused_kernel<2>"),
              (690, 692, 698, "fused_kernel<2>")]
TRAIN_SPANS = [
    ("bnn.predict", 100, 300), ("predict.to_host", 180, 260),
    ("bnn.predict", 600, 700), ("predict.to_host", 620, 700),
]
TRAIN_OPS = [(110, 120, 170), (610, 612, 615)]


def _run(spans, ops):
    return harness.Run(types.SimpleNamespace(counts={}),
                       Trace(_events(spans, ops)), None)


def _read(metric, run):
    return harness.reader(metric)(run)


def test_svgd_readers_by_hand():
    run = _run(SVGD_SPANS, SVGD_OPS)
    # gradient: [100, 200] idle but [120, 150]: 70; [500, 640] idle but
    # [600, 640]: 100; mean over the two steps in the window
    assert _read("grad_idle_ms.svgd", run) == pytest.approx(85e-6)
    # update: [350, 400] idle but [370, 380]: 40; [780, 800] idle but
    # [780, 790]: 10
    assert _read("update_idle_ms.svgd", run) == pytest.approx(25e-6)
    # bandwidth: launched inside it 25 + 22 and 30 ns of device time
    assert _read("bandwidth_ms.svgd", run) == pytest.approx(38.5e-6)


def test_sample_prologue_reader_by_hand():
    run = _run(SAMPLE_SPANS, SAMPLE_OPS)
    # [100, 165] idle but [100, 130]: 35; [500, 535] idle but [510, 515]:
    # 30; the call with no fused kernel and the burn-in not counted
    assert _read("prologue_idle_ms.sample", run) == pytest.approx(32.5e-6)


def test_burnin_prologue_reader_by_hand():
    run = _run(BURNIN_SPANS, BURNIN_OPS)
    # [110, 150] idle: 40; [300, 320] idle but [300, 314]: 6; the call
    # outside ``bnn.burn_in`` not counted
    assert _read("prologue_idle_ms.train", run) == pytest.approx(23e-6)


def test_train_to_host_reader_by_hand():
    run = _run(TRAIN_SPANS, TRAIN_OPS)
    assert _read("to_host_ms.train", run) == pytest.approx(80e-6)


@pytest.mark.parametrize("spans, ops", [(SVGD_SPANS, SVGD_OPS),
                                        (SAMPLE_SPANS, SAMPLE_OPS),
                                        (BURNIN_SPANS, BURNIN_OPS)])
def test_idle_inside_a_span_is_the_traces_own(spans, ops):
    """The bisected idle time equals ``Trace.idle_between`` over every busy
    interval, for every span and for spans across busy intervals' ends."""
    trace = Trace(_events(spans, ops))
    index = program.Spans(trace)
    cuts = sorted({t for _, s, e in spans for t in (s, e)}
                  | {t for _, s, e, *_ in ops for t in (s, e)})
    for start in cuts:
        for end in cuts:
            if end >= start:
                assert index.idle_ns(start, end) == \
                    trace.idle_between(start, end), (start, end)


def test_device_annotations_are_not_operations():
    """A span's mirror on the device's timeline is no device operation."""
    events = _events(SVGD_SPANS, SVGD_OPS) + [
        Event("pysgmcmc.svgd.step", 100, 400, cuda=True)]
    run = harness.Run(types.SimpleNamespace(counts={}), Trace(events), None)
    assert _read("grad_idle_ms.svgd", run) == pytest.approx(85e-6)


READERS = ["prologue_idle_ms.sample", "prologue_idle_ms.train",
           "to_host_ms.train", "grad_idle_ms.svgd", "bandwidth_ms.svgd",
           "update_idle_ms.svgd"]


def _cpu_trace():
    """A CPU profile of one streaming SVGD step inside the window span:
    the program's spans, no device operation."""
    sampler = SVGDSampler(lambda p: 0.5 * torch.sum(p["x"] ** 2),
                          kernel_impl="streaming", streaming_interpret=True,
                          streaming_tile=4)
    state = sampler.init({"x": torch.randn(
        8, 2, generator=torch.Generator().manual_seed(0))})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("perfbench.window"):
            sampler.step(state, torch.Generator())
    return Trace(prof.profiler.kineto_results.events())


@pytest.mark.parametrize("metric", READERS)
def test_nothing_to_read_is_none(metric):
    cell = types.SimpleNamespace(counts={})
    assert _read(metric, harness.Run(cell, None, None)) is None
    cpu = _cpu_trace()
    assert any(name == "pysgmcmc.svgd.step" for _, _, name in cpu.host)
    assert _read(metric, harness.Run(cell, cpu, None)) is None
    # a program that records no spans (the parent's): device work only
    assert _read(metric, _run([], SVGD_OPS)) is None
