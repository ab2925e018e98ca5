"""Timers and spans — the profiling/tracing subsystem (grown from a copy
of ``quantum_simulations_tpu/utils/timing.py``).

Parity with the reference's ad-hoc perf counters (hisvsim's
``obtain_apply_time``/``obtain_gate_counter``/``obtain_gather_time``,
``execute.hpp:18-31``): named accumulating timers with a context-manager
interface, a global registry, and a snapshot API the bench suite and
runners report from.

:func:`span` marks a layer boundary of the port (``qst.api.run``,
``qst.compile``, ``qst.readout.expectation_z``, ...).  While a
``torch.profiler`` records, it opens ``torch.profiler.record_function``
(a ``user_annotation`` in the exported trace, on the kernels' clock) and
adds its host seconds to :data:`GLOBAL`; otherwise it is one shared null
context and does nothing.  :func:`timer` always accumulates and opens
the same annotation while a profiler records.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_OFF = contextlib.nullcontext()


class Metrics:
    """Accumulating named timers and their call counts."""

    def __init__(self):
        self.timers: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] += time.perf_counter() - t0
            self.counts[f"{name}.calls"] += 1

    def snapshot(self) -> dict:
        return {
            "timers_s": dict(self.timers),
            "counts": dict(self.counts),
        }

    def reset(self) -> None:
        self.timers.clear()
        self.counts.clear()


GLOBAL = Metrics()


def _annotation(name: str):
    """``record_function(name)`` while a profiler records, else the null
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextmanager
def timer(name: str):
    with GLOBAL.timer(name), _annotation(name):
        yield


def span(name: str):
    """A layer boundary: :func:`timer` while a profiler records, else the
    shared null context."""
    if torch.autograd._profiler_enabled():
        return timer(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call inside :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def snapshot() -> dict:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
