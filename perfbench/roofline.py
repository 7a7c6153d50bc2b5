"""The chip's peaks and the least time a counted piece of work needs on
it: the larger of its products at the TF32 tensor-core peak, its float32
elementwise operations at the float32 peak, and its bytes at the memory's
peak (the pipes may overlap; none can be skipped)."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peaks(device_name):
    """The published peaks of ``device_name``, or ``None`` (no share of a
    peak is then reported)."""
    with open(PEAKS) as f:
        table = json.load(f)
    return table.get(device_name)


def least_seconds(work, peak):
    return max(work["tc_flops"] / peak["tf32_flops"],
               work["f32_flops"] / peak["f32_flops"],
               work["bytes"] / peak["hbm_bytes_per_s"])


def total(works):
    """The sum of counted works, key by key."""
    out = dict(tc_flops=0, f32_flops=0, bytes=0)
    for w in works:
        for key in out:
            out[key] += w[key]
    return out
