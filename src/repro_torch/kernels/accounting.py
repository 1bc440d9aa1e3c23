"""Where the hand kernels' wrappers find the cost counter in force
(``launch/op_cost.OpCounter``), so that they import nothing above the
kernels.  A counter pushes itself on ``ACTIVE`` while it is entered; with
none in force a wrapper pays one empty-list test and builds no cost."""
from __future__ import annotations

ACTIVE: list = []  # the counters in force, innermost last


def counter(device):
    """The innermost counter in force if it counts ``device`` and is not
    quiet (inside another kernel's call), else None."""
    if not ACTIVE:
        return None
    c = ACTIVE[-1]
    return c if c.device == device and not c._quiet else None
