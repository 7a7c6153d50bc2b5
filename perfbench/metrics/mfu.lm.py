"""mfu.lm: the window's counted products (``perfbench/work/moe_lm.py``:
every token's matrices and the attention core at each step, the held
experts' at the assignments the program counted, ``moe.held_assignments``)
over the window at the TF32 peak, %."""

from perfbench import readers
from perfbench.work import moe_lm


def read(run):
    cfg, counts = run.cell.net_config, run.counts
    if not counts.get("held_assignments"):
        return None
    flops = counts["steps"] * moe_lm.step_products(
        cfg, cfg["batch_size"], cfg["sequence_length"]) \
        + moe_lm.expert_products(cfg, counts["held_assignments"])
    return readers.mfu(run, [moe_lm.work(tc_flops=flops)])
