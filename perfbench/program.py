"""What the program's own spans say: the spans ``pysgmcmc.<name>`` that
``pysgmcmc_tpu_torch.utils.tracing`` records inside the port while the
profiler traces the window, on the device trace's clock.

The readers of ``perfbench/metrics/`` that read them take, for the window's
spans of one name (nested in another's, where asked): the device-idle time
inside them, the device time of the operations launched inside them (by
the launch's timestamp, as :meth:`perfbench.trace.Trace.in_spans` takes the
benchmark's spans), their own duration on the host, or the device-idle time
from a fused driver call's start to the launch of its first fused kernel
(its prologue), each per span of a counting name.  Each returns ``None``
where there is nothing to read: no trace, no device operation (a CPU run),
or no span of the counting name (a program that records none).
"""

import bisect

# the port's own prefix (``pysgmcmc_tpu_torch.utils.tracing.PREFIX``), kept
# here: a program that predates its spans has no such module to import
PREFIX = "pysgmcmc."
# the fused drivers' kernels, as the device trace names them
FUSED_KERNEL = "fused_kernel"


def _inside(spans, starts, t):
    """The index of the span of ``spans`` (sorted, not overlapping; their
    ``starts``) that holds ``t``, or ``None``."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t <= spans[i][1] else None


class Spans:
    """The window's program spans of a trace by name, sorted ``(start_ns,
    end_ns)``, and the device's busy intervals indexed by their ends."""

    def __init__(self, trace):
        self.trace = trace
        self.by_name = {}
        for start, end, name in trace.host:
            if name.startswith(PREFIX) and trace.start <= start \
                    and end <= trace.end:
                self.by_name.setdefault(name[len(PREFIX):], []).append(
                    (start, end))
        self.busy_ends = [end for _, end in trace.busy]

    def named(self, name, within=None):
        """The spans ``name``; with ``within``, only those inside a span
        ``within``."""
        spans = self.by_name.get(name, [])
        if within is None:
            return spans
        parents = self.by_name.get(within, [])
        starts = [start for start, _ in parents]
        return [(start, end) for start, end in spans
                if (i := _inside(parents, starts, start)) is not None
                and end <= parents[i][1]]

    def idle_ns(self, start, end):
        """Nanoseconds in ``[start, end]`` in which no device operation ran,
        over the busy intervals that can meet it (found by bisection: a
        window holds thousands of spans)."""
        lo = bisect.bisect_right(self.busy_ends, start)
        hi = bisect.bisect_left(self.busy_ends, end) + 1
        busy = sum(max(0, min(e, end) - max(s, start))
                   for s, e in self.trace.busy[lo:hi])
        return max(0, end - start - busy)

    def launched(self, spans):
        """The device operations launched inside ``spans`` (sorted, not
        overlapping), with the index of the span of each."""
        starts = [start for start, _ in spans]
        return [(i, op) for op in self.trace.ops
                if (i := _inside(spans, starts, op[3])) is not None]

    def launched_ns(self, spans):
        """Device nanoseconds of the operations launched inside ``spans``."""
        return sum(op[1] - op[0] for _, op in self.launched(spans))


def _spans(run):
    """The run's program spans, or ``None`` with no trace or no device
    operation."""
    trace = run.trace
    return None if trace is None or not trace.ops else Spans(trace)


def _read(run, per, measure):
    """``measure(spans)`` in nanoseconds, in ms per span ``per``, or
    ``None`` where the run has nothing to read."""
    spans = _spans(run)
    count = len(spans.named(per)) if spans else 0
    if count == 0:
        return None
    return measure(spans) / count * 1e-6


def idle_ms(run, name, per):
    """Device-idle ms inside the spans ``name``, per span ``per``."""
    return _read(run, per, lambda spans: sum(
        spans.idle_ns(s, e) for s, e in spans.named(name)))


def device_ms(run, name, per):
    """Device ms of the operations launched inside the spans ``name``, per
    span ``per``."""
    return _read(run, per,
                 lambda spans: spans.launched_ns(spans.named(name)))


def host_ms(run, name, per):
    """Host ms of the spans ``name`` themselves, per span ``per``."""
    return _read(run, per, lambda spans: sum(
        e - s for s, e in spans.named(name)))


def prologue_idle_ms(run, driver, within=None):
    """Device-idle ms of the fused driver calls ``driver`` (nested in
    ``within``) from each call's start to the launch of its first fused
    kernel, per call that launched one."""
    spans = _spans(run)
    if spans is None:
        return None
    calls = spans.named(driver, within)
    first = {}
    for i, op in spans.launched(calls):
        if FUSED_KERNEL in op[2]:
            first[i] = min(first.get(i, op[3]), op[3])
    if not first:
        return None
    return sum(spans.idle_ns(calls[i][0], launch)
               for i, launch in first.items()) / len(first) * 1e-6
