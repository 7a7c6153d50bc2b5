"""attention_roofline: the attention core's counted products in both passes
(``perfbench/work/moe_lm.py``: the causal pairs of every head, sequence and
layer at each of the window's steps) at the TF32 peak over the device time
of what was launched inside the program's ``mla.attention`` spans (forward
and backward), %."""

from perfbench import program, roofline
from perfbench.work import moe_lm


def read(run):
    cfg, steps = run.cell.net_config, run.counts.get("steps")
    spans = program._spans(run)
    if not steps or spans is None or run.peaks is None:
        return None
    ns = spans.launched_ns(spans.named("mla.attention"))
    if ns <= 0:
        return None
    work = moe_lm.work(tc_flops=steps * moe_lm.attention_products(
        cfg, cfg["batch_size"], cfg["sequence_length"]))
    return 100.0 * roofline.least_seconds(work, run.peaks) / (ns * 1e-9)
