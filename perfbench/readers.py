"""What the per-layer readers (``perfbench/metrics/<name>.py``) share: the
work a run counted in its window, and the shares of the chip's peaks and
of a role's least time that the trace gives.  Each returns ``None`` where
the run has nothing to read (no trace, no peak for the device, no device
time in the role's spans)."""

from perfbench import roofline
from perfbench.reference.stream import n_params
from perfbench.work import burnin, network, predict, sampling, transport


def _fused_work(run, kind):
    cell = run.cell
    cfg = cell.config
    for launch in run.counts.get("launches", []):
        if launch["kind"] != kind:
            continue
        if kind == "burn":
            yield burnin.work(cell.shape, cfg["batch_size"], cfg["n_data"],
                              launch["n_chains"], launch["n_steps"])
        else:
            yield sampling.work(cell.shape, cfg["batch_size"],
                                cfg["n_data"], launch["n_chains"],
                                launch["n_keep"], launch["keep_every"])


def device_seconds(run, span):
    """Seconds of the device operations launched inside spans ``span``."""
    if run.trace is None:
        return 0.0
    return sum(end - start for start, end, _, _ in
               run.trace.in_spans(span)) * 1e-9


def roofline_share(run, works, span):
    """The least time of ``works`` over the device time of ``span``, %."""
    seconds = device_seconds(run, span)
    works = list(works)
    if run.peaks is None or seconds <= 0 or not works:
        return None
    least = sum(roofline.least_seconds(w, run.peaks) for w in works)
    return 100.0 * least / seconds


def idle_share(run):
    """The window's share in which no device operation ran, %."""
    trace = run.trace
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(run, works):
    """The works' products over the window at the TF32 peak, %."""
    trace = run.trace
    works = list(works)
    if trace is None or run.peaks is None or trace.window_s <= 0 \
            or not works:
        return None
    flops = roofline.total(works)["tc_flops"]
    return 100.0 * flops / (trace.window_s * run.peaks["tf32_flops"])


def burnin_works(run):
    return list(_fused_work(run, "burn"))


def sampling_works(run):
    return list(_fused_work(run, "sample"))


def predict_works(run):
    """Each predict call of the window: every member at every point."""
    cell = run.cell
    calls, points = run.counts.get("predict_calls", (0, 0))
    return [predict.work(cell.shape, cell.n_chains, points)] * calls


def svgd_works(run):
    """Each window step: every particle's gradient products and the
    transport."""
    cell = run.cell
    steps = [transport.work(cell.n, n_params(*cell.shape))] \
        * run.counts.get("steps", 0)
    grads = network.gradient_products(cell.shape, cell.config["batch_size"])
    return [dict(w, tc_flops=w["tc_flops"] + cell.n * grads) for w in steps]
