"""Stepsize schedules (PyTorch port of :mod:`pysgmcmc_tpu.stepsize_schedules`).

A schedule is ``(init, value, update)``: ``value(state, step)`` gives the
stepsize at an absolute step, so the fused drivers can build a per-step
table for a whole kernel launch.  Only the constant schedule is ported so
far; the traced, polynomial-decay and cyclical schedules are listed in
``ROADMAP.md`` (queue A).

Examples
--------
>>> schedule = ConstantStepsizeSchedule(0.01)
>>> next(schedule)
0.01
>>> from itertools import islice
>>> list(islice(schedule, 3))
[0.01, 0.01, 0.01]
"""


class StepsizeSchedule:
    """Base class: ``init() -> state``, ``value(state, step) -> float``,
    ``update(state, **info) -> state``; iterating yields successive
    values from host-side state (reference API parity)."""

    def __init__(self, initial_value):
        self.initial_value = initial_value
        self._host_step = 0
        self._host_state = self.init()

    def init(self):
        return ()

    def value(self, state, step):
        raise NotImplementedError

    def update(self, state, **info):
        """Feedback hook; default is a no-op."""
        return state

    def __iter__(self):
        return self

    def __next__(self):
        out = self.value(self._host_state, self._host_step)
        self._host_step += 1
        return float(out)


class ConstantStepsizeSchedule(StepsizeSchedule):
    """Constant stepsize."""

    def value(self, state, step):
        return self.initial_value

    def __str__(self):
        return "ConstantStepsizeSchedule(stepsize={})".format(self.initial_value)
