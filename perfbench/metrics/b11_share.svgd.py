"""b11_share.svgd: the device time of what the ``svgd_phi_streaming`` calls
(kernel B11) launched, as a share of the window's device-busy time, %."""

from perfbench import readers


def read(run):
    trace = run.trace
    if trace is None or trace.busy_s <= 0:
        return None
    seconds = readers.device_seconds(run, "svgd_phi_streaming")
    return 100.0 * seconds / trace.busy_s if seconds > 0 else None
