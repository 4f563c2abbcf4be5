"""The faults a cell's comparison has to catch, planted in the timed path
underneath the harness: a solver adapter that wraps the cell's own."""

from __future__ import annotations

import dataclasses

FAULTS = ("unchanged", "half", "altered", "short")


class Broken:
    """A solver adapter whose timed path is broken underneath: ``fault`` is
    ``unchanged`` (the align returns its start), ``half`` (half the scan
    left out), ``altered`` (the answer moved by 1 cm where it is made) or
    ``short`` (the loop stops one update early: its gate loosened to just
    above the last step it applied)."""

    def __init__(self, solver, fault: str):
        self.solver, self.fault = solver, fault
        self.LOOP_KERNEL = solver.LOOP_KERNEL
        self.make, self.set_target, self.outcome = solver.make, solver.set_target, solver.outcome

    def align(self, s, scan, init_T):
        if self.fault == "half":
            return self.solver.align(s, scan[: scan.shape[0] // 2], init_T)
        T = self.solver.align(s, scan, init_T)
        if self.fault == "unchanged":
            return init_T.copy()
        if self.fault == "short":
            return self._short(s, scan, init_T, T)
        T = T.copy()
        T[0, 3] += 0.01
        return T

    def _short(self, s, scan, init_T, T):
        iterations, _, dx = self.solver.outcome(s)
        cfg = s.cfg
        updates = iterations - 1 if dx and dx[-1] < cfg.tol else iterations
        if updates < 1:
            return T
        s.cfg = dataclasses.replace(cfg, tol=float(dx[updates - 1]) * (1 + 1e-4))
        try:
            return self.solver.align(s, scan, init_T)
        finally:
            s.cfg = cfg
