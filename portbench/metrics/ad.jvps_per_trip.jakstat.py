"""Forward-mode AD derivatives (solvers/common.py batched_jacobian, sens/forward.py): jvps of the AD derivatives (the program's ``ad.jvps``: n a state Jacobian, one a sensitivity column) per trip of the batched step loop (``bdf.trips``), over the whole run; None where the program has no such counter."""

from portbench.metrics import _program


def read(trace):
    tr = _program._trace()
    if tr is None or "ad.jvps" not in tr.counters():
        return None
    return _program.per_count("ad.jvps", "bdf.trips")
