"""What the port records of itself, for the readers in ``metrics/``: its
spans (``qst.*`` user annotations in the traced run's trace, on the
kernels' clock) and its host counters.

A port that lacks them, as an older one does, gives no reading: the
span helpers return None when the trace holds no ``qst.*`` span at all,
and :func:`present` leaves out a counter the port does not define, so
the harness never asks for it.
"""
from __future__ import annotations

import importlib

from .systems import PACKAGE

PREFIX = "qst."


def present(specs: list[str]) -> list[str]:
    """The counters ``"<module>:<NAME>"`` among ``specs`` that the port
    defines."""
    out = []
    for spec in specs:
        mod, name = spec.split(":")
        try:
            module = importlib.import_module(f"{PACKAGE}.{mod}")
        except ImportError:
            continue
        if hasattr(module, name):
            out.append(spec)
    return out


def intervals(run, match) -> list | None:
    """The host time (µs on the trace's clock) of the spans whose name
    ``match`` accepts, clipped to the window, as disjoint ``[start, end)``
    intervals: a span inside another is counted once.  None when the
    trace has no ``qst.*`` span."""
    tr = run.trace
    if tr is None:
        return None
    rows = tr._spans[1]
    if not any(name.startswith(PREFIX) for _, _, name in rows):
        return None
    out: list = []
    for a, b, name in rows:  # sorted by start
        if not match(name):
            continue
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def ms_per_request(run, match) -> float | None:
    """:func:`intervals`' milliseconds over the window, per completed
    request."""
    iv = intervals(run, match)
    if iv is None or not run.requests:
        return None
    return 1e-3 * sum(b - a for a, b in iv) / run.requests
