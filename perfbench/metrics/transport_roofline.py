"""transport_roofline: the least time of the window's SVGD transport
directions (``perfbench/work/transport.py``) over the device time of what
the ``svgd_phi_streaming`` calls (kernel B11) launched, %."""

from perfbench import readers
from perfbench.reference.stream import n_params
from perfbench.work import transport


def read(run):
    cell = run.cell
    works = [transport.work(cell.n, n_params(*cell.shape))] \
        * run.counts.get("steps", 0)
    return readers.roofline_share(run, works, "svgd_phi_streaming")
