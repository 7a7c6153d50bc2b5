"""Named spans inside the port, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function("pysgmcmc." + name)``
while a profiler records and one shared no-op context otherwise: with no
profiler the program never enters it.  Recorded by a profiler that also
traces the card, each span shares the device trace's timeline, so a device
operation's launch and every idle interval fall inside the spans open at
the time.  ``spanned(name)`` wraps a whole function in ``span(name)``.

Examples
--------
>>> with span("example"):
...     pass
>>> spanned("example")(abs)(-2)
2
"""

import contextlib
import functools

import torch

PREFIX = "pysgmcmc."
_OFF = contextlib.nullcontext()


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


__all__ = ["PREFIX", "span", "spanned"]
