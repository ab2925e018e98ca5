"""Timers and counters — the profiling/tracing subsystem (a copy of
``quantum_simulations_tpu/utils/timing.py``).

Parity with the reference's ad-hoc perf counters (hisvsim's
``obtain_apply_time``/``obtain_gate_counter``/``obtain_gather_time``,
``execute.hpp:18-31``): named accumulating timers + counters with a
context-manager interface, a global registry, and a snapshot API the
bench suite and runners report from.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    """Accumulating named timers and counters."""

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

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def snapshot(self) -> dict:
        return {
            "timers_s": dict(self.timers),
            "counts": dict(self.counts),
        }

    def reset(self) -> None:
        self.timers.clear()
        self.counts.clear()


GLOBAL = Metrics()


@contextmanager
def timer(name: str):
    with GLOBAL.timer(name):
        yield


def snapshot() -> dict:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
