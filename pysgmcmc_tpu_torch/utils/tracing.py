"""Named spans inside the port, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function("pysgmcmc." + name)``
while a profiler records and one shared no-op context otherwise: with no
profiler the program never enters it.  Recorded by a profiler that also
traces the card, each span shares the device trace's timeline, so a device
operation's launch and every idle interval fall inside the spans open at
the time.  ``spanned(name)`` wraps a whole function in ``span(name)``.
``traced(name, fn, *tensors)`` calls ``fn(*tensors)`` inside ``span(name)``
as one node of the autograd graph, whose backward pass runs inside a span of
the same name too, so that the kernels of both passes fall inside it.
``count(name, n)`` adds ``n`` to ``counts[name]`` while a profiler records,
and does nothing otherwise.

Examples
--------
>>> with span("example"):
...     pass
>>> spanned("example")(abs)(-2)
2
>>> traced("example", torch.mul, torch.ones(2), torch.ones(2)).tolist()
[1.0, 1.0]
>>> count("example", 3)  # no profiler records: nothing is counted
>>> "example" in counts
False
"""

import contextlib
import functools

import torch

PREFIX = "pysgmcmc."
_OFF = contextlib.nullcontext()
# what count() added while a profiler recorded, by name; readers may clear it
counts = {}


def span(name):
    """The span ``pysgmcmc.<name>`` while a profiler records, else a no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name, n):
    """Add ``n`` to ``counts[name]`` while a profiler records, else
    nothing."""
    if torch.autograd._profiler_enabled():
        counts[name] = counts.get(name, 0) + int(n)


class _BothPasses(torch.autograd.Function):
    """``fn(*tensors)`` as one node of the graph: the forward builds
    ``fn``'s own graph on detached inputs, the backward differentiates it
    inside ``span(name)``."""

    @staticmethod
    def forward(ctx, name, fn, *tensors):
        inner = [t.detach().requires_grad_() if t.requires_grad else t
                 for t in tensors]
        with torch.enable_grad():
            out = fn(*inner)
        single = torch.is_tensor(out)
        outs = (out,) if single else tuple(out)
        results = tuple(o.detach() for o in outs)
        ctx.mark_non_differentiable(
            *[r for r, o in zip(results, outs) if not o.requires_grad])
        ctx.name, ctx.inner, ctx.outs = name, inner, outs
        return results[0] if single else results

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad and g is not None]
        wanted = [t for t in ctx.inner if t.requires_grad]
        got = [None] * len(wanted)
        if pairs and wanted:
            with span(ctx.name):
                got = torch.autograd.grad(
                    [o for o, _ in pairs], wanted, [g for _, g in pairs],
                    allow_unused=True)
        got = iter(got)
        flags = [t.requires_grad for t in ctx.inner]
        ctx.inner = ctx.outs = None
        return (None, None) + tuple(next(got) if f else None for f in flags)


def traced(name, fn, *tensors):
    """``fn(*tensors)`` (a tensor or a tuple of tensors) inside
    ``span(name)``, as one node of the autograd graph whose backward runs
    inside ``span(name)`` as well, so that the spans of that name hold the
    kernels of both passes, traced or not.  Every tensor ``fn``
    differentiates must be one of ``tensors``."""
    with span(name):
        return _BothPasses.apply(name, fn, *tensors)


__all__ = ["PREFIX", "count", "counts", "span", "spanned", "traced"]
