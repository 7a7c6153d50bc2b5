"""lanes_update_roofline: the bytes of the window's sampling updates (B7:
theta, v, minv and the gradient read once, theta and v written once,
float32) at the memory's peak over the device time of what was launched
inside the program's ``lanes.update`` spans within ``lanes.sample``, %."""

from perfbench import program, roofline
from perfbench.work import moe_lm


def read(run):
    spans = program._spans(run)
    if spans is None or run.peaks is None:
        return None
    updates = spans.named("lanes.update", within="lanes.sample")
    ns = spans.launched_ns(updates)
    if not updates or ns <= 0:
        return None
    work = moe_lm.work(nbytes=len(updates) * moe_lm.update_bytes(
        run.cell.n_params))
    return 100.0 * roofline.least_seconds(work, run.peaks) / (ns * 1e-9)
