"""Forward-mode AD derivatives (solvers/common.py batched_jacobian, sens/forward.py): in the profiled unit, the time of the ``ad.jac`` and ``ad.sens`` spans inside each ``bdf.trip`` (state Jacobians and sensitivity columns by jvp), ms per trip; None where the program records no ``ad.*`` span."""

from portbench.metrics import _program


def read(trace):
    tr = _program._trace()
    if tr is None or not any(s.name.startswith("ad.") for s in tr.spans()):
        return None
    held = [_program.less_inner_ms("bdf.trip", name, inner_only=True)
            for name in ("ad.jac", "ad.sens")]
    return None if None in held else sum(held)
