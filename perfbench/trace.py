"""What the profiler saw in a traced window: the device's operations, the
benchmark's spans, and what the host was doing in each gap.

Built from ``torch.profiler``'s raw events.  A device operation belongs to a
span when the host call that launched it (the CUDA runtime call of the same
correlation id) lies inside the span; the kernels that the port launches
through ``ctypes`` are traced like PyTorch's own.
"""

import bisect

SPAN_PREFIX = "perfbench."


def _is_annotation(event, name):
    """A span's mirror on the device's timeline, not an operation."""
    flag = getattr(event, "is_user_annotation", None)
    return name.startswith(SPAN_PREFIX) or bool(flag and flag())


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Trace:
    """The traced window's device operations ``(start_ns, end_ns, name,
    launch_ns)``, the benchmark's spans ``(name, start_ns, end_ns)`` and
    the host's other events."""

    def __init__(self, events, window_name="window"):
        self.ops, self.spans, self.host = [], [], []
        launches = {}
        device_events = []
        for ev in events:
            kind = str(ev.device_type())
            name = ev.name()
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if kind.endswith("CUDA"):
                if not _is_annotation(ev, name):
                    device_events.append((start, end, name,
                                          ev.correlation_id()))
            elif name.startswith(SPAN_PREFIX):
                self.spans.append((name[len(SPAN_PREFIX):], start, end))
            else:
                if name.startswith("cuda"):
                    launches[ev.correlation_id()] = start
                self.host.append((start, end, name))
        for start, end, name, corr in device_events:
            self.ops.append((start, end, name, launches.get(corr, start)))
        self.ops.sort()
        self.host.sort()
        windows = [s for s in self.spans if s[0] == window_name]
        if windows:
            self.start, self.end = windows[0][1], windows[0][2]
        elif self.ops:
            self.start, self.end = self.ops[0][0], self.ops[-1][1]
        else:
            self.start = self.end = 0
        self.ops = [op for op in self.ops
                    if op[1] > self.start and op[0] < self.end]
        self.busy = _union([(max(s, self.start), min(e, self.end))
                            for s, e, _, _ in self.ops])

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy) * 1e-9

    def in_spans(self, span_name):
        """The device operations launched inside a span ``span_name``."""
        spans = sorted((s, e) for n, s, e in self.spans if n == span_name)
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op[3]) - 1
            if i >= 0 and op[3] <= spans[i][1]:
                out.append(op)
        return out

    def idle_between(self, start, end):
        """Nanoseconds in ``[start, end]`` in which no operation ran."""
        busy = 0
        for s, e in self.busy:
            lo, hi = max(s, start), min(e, end)
            if hi > lo:
                busy += hi - lo
        return max(0, end - start - busy)

    def gaps(self):
        """The idle intervals of the window."""
        out, cursor = [], self.start
        for s, e in self.busy:
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if self.end > cursor:
            out.append((cursor, self.end))
        return out

    def host_at(self, t):
        """What the host was doing at ``t``: the innermost benchmark span
        and the innermost other host event that cover it."""
        def innermost(items):
            best = None
            for name, s, e in items:
                if s <= t <= e and (best is None or s >= best[1]):
                    best = (name, s)
            return best[0] if best else None

        span = innermost(self.spans)
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        event = None
        while i >= 0:
            s, e, name = self.host[i]
            if e >= t:
                event = name
                break
            if t - s > 10**10:
                break
            i -= 1
        return "{} / {}".format(span or "-", event or "python")

    def breakdown(self, n=10):
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing, ``n`` of each."""
        totals = {}
        for s, e, name, _ in self.ops:
            totals[name] = totals.get(name, 0) + (min(e, self.end)
                                                  - max(s, self.start))
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {
            "device_ops": [[name[:160], ns * 1e-9] for name, ns in ops],
            "idle_gaps": [[self.host_at(s), (e - s) * 1e-9]
                          for s, e in gaps],
        }
