"""What the modes share: the cell object's base, the training data, the
seeds they derive, the rows a check follows, the gaps they compare and the
spans they record."""

import contextlib

import numpy as np
import torch

# the share of a check's rows whose gaps a number's reading lies above: a
# fault in a tenth of the rows or more reads as that fault
QUANTILE = 0.9


def sinc_data(seed, n_data, device):
    """``n_data`` points ``x ~ U(0, 1)``, ``y = sinc(10 x - 5)`` from
    ``seed`` (host arrays, as the model takes them), and the same data
    normalised to zero mean and unit variance in float64 and cast to
    float32 on ``device``, with the constants: ``(x, y, x_dev, y_dev,
    (x_mean, x_std, y_mean, y_std))``."""
    rng = np.random.default_rng(int(seed))
    x = rng.uniform(0.0, 1.0, (n_data, 1))
    y = np.sinc(x[:, 0] * 10.0 - 5.0)
    x_mean, x_std = x.mean(axis=0), x.std(axis=0)
    y_mean, y_std = y.mean(), y.std()
    x_dev = torch.as_tensor((x - x_mean) / x_std, dtype=torch.float32,
                            device=device)
    y_dev = torch.as_tensor((y - y_mean) / y_std, dtype=torch.float32,
                            device=device)
    return x, y, x_dev, y_dev, (x_mean, x_std, y_mean, y_std)


def derived_seed(seed, index):
    """The seed of the ``index``-th unit of work of a run of ``seed``."""
    return (int(seed) * 1000003 + 7919 * int(index) + 17) % (2**62)


def chosen(seed, n, k):
    """``k`` of ``range(n)`` drawn from ``seed`` (sorted, int64, CPU)."""
    gen = torch.Generator().manual_seed(derived_seed(seed, 10**6))
    return torch.sort(torch.randperm(n, generator=gen)[:min(k, n)]).values


def row_gaps(program, reference):
    """Each row's widest gap: ``max_j |p - r| / max_j |r|`` (float64)."""
    p = program.double()
    r = reference.double()
    scale = r.abs().amax(dim=-1).clamp_min(1e-30)
    return (p - r).abs().amax(dim=-1) / scale


def relative_gaps(program, reference):
    """``|p - r| / |r|`` elementwise (float64)."""
    r = reference.double()
    return (program.double() - r).abs() / r.abs().clamp_min(1e-30)


def high_gap(gaps):
    """The :data:`QUANTILE` quantile of the rows' gaps (float)."""
    return float(torch.quantile(gaps.double().reshape(-1), QUANTILE))


def summarise(gaps):
    """Each number of a check from its rows' gaps, ``{name: [tensor, ...]}``
    with names ending in ``_gap``: under ``name`` the worst of the tensors'
    :func:`high_gap`, under ``name`` ending in ``_median`` instead the worst
    of their medians.  A cell's limits name the numbers it holds: the high
    quantile sees a fault in part of the rows, the median a change of
    precision, which moves every row, where a few rows' rounding grows too
    far for the high quantile to see it (``PERF.md``)."""
    numbers = {}
    for name, tensors in gaps.items():
        if tensors:
            numbers[name] = max(high_gap(g) for g in tensors)
            numbers[name[:-len("_gap")] + "_median"] = max(
                float(g.double().median()) for g in tensors)
    return numbers


def scalar_gap(program, reference):
    """``max |p - r| / max |r|`` over all elements (float)."""
    p = torch.as_tensor(program).double().reshape(-1)
    r = torch.as_tensor(reference).double().reshape(-1)
    return float((p - r).abs().max() / r.abs().max().clamp_min(1e-30))


class Spans:
    """Named host spans around the calls into each layer, recorded into the
    profiler's trace when tracing (``perfbench.<name>``), else free."""

    def __init__(self, tracing):
        self.tracing = tracing

    def __call__(self, name):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function("perfbench." + name)

    @contextlib.contextmanager
    def around(self, module, attr, name, after=None):
        """Replace ``module.attr`` by a call inside the span ``name``;
        ``after(args, kwargs, result)`` sees each call.  Restored on exit."""
        original = getattr(module, attr)

        def spanned(*args, **kwargs):
            with self(name):
                result = original(*args, **kwargs)
            if after is not None:
                after(args, kwargs, result)
            return result

        setattr(module, attr, spanned)
        try:
            yield
        finally:
            setattr(module, attr, original)


class Cell:
    """One run of a cell: its configuration, traffic, seed and device, the
    spans it records, and the counts the per-layer readers take."""

    def __init__(self, config, traffic, seed, device, spans):
        self.config = dict(config)
        self.traffic = dict(traffic)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.spans = spans
        self.counts = {}

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        """Drop what the check does not need (before the reference runs)."""
