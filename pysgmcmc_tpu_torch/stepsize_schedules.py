"""Stepsize schedules (PyTorch port of :mod:`pysgmcmc_tpu.stepsize_schedules`).

A schedule is ``(init, value, update)``: ``value(state, step)`` gives the
stepsize at an absolute step, so the fused drivers can build a per-step
table for a whole kernel launch.  The constant and traced schedules are
ported; the polynomial-decay and cyclical schedules are listed in
``ROADMAP.md`` (queue A).

Examples
--------
>>> schedule = ConstantStepsizeSchedule(0.01)
>>> next(schedule)
0.01
>>> from itertools import islice
>>> list(islice(schedule, 3))
[0.01, 0.01, 0.01]
>>> traced = TracedStepsizeSchedule(0.5)
>>> float(traced.value(traced.init(), 7))
0.5
"""

import torch


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


class TracedStepsizeSchedule(StepsizeSchedule):
    """Constant stepsize carried in the schedule state.

    ``value`` reads the stepsize from ``schedule_state``, so replacing the
    state changes the stepsize without rebuilding the sampler.  Stacked
    per chain (a ``(n_chains,)`` state), it gives every chain its own
    stepsize: the chains-on-lanes drivers turn it into a per-chain eps
    vector (the stepsize-sweep pattern).
    """

    def init(self):
        return torch.tensor(self.initial_value, dtype=torch.float32)

    def value(self, state, step):
        return state

    def __str__(self):
        return "TracedStepsizeSchedule(initial={})".format(self.initial_value)
