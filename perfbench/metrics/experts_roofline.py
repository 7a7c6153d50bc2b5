"""experts_roofline: the held experts' counted products in both passes
(``perfbench/work/moe_lm.py``, at the assignments the program counted,
``moe.held_assignments``) at the TF32 peak over the device time of what was
launched inside the program's ``moe.experts`` spans (forward and backward),
%."""

from perfbench import program, roofline
from perfbench.work import moe_lm


def read(run):
    assignments = run.counts.get("held_assignments")
    spans = program._spans(run)
    if not assignments or spans is None or run.peaks is None:
        return None
    ns = spans.launched_ns(spans.named("moe.experts"))
    if ns <= 0:
        return None
    work = moe_lm.work(tc_flops=moe_lm.expert_products(run.cell.net_config,
                                                       assignments))
    return 100.0 * roofline.least_seconds(work, run.peaks) / (ns * 1e-9)
