"""The traced run: ``torch.profiler`` (CPU and CUDA activities) over the
window, read back from its Chrome trace.

The trace is written under ``TMPDIR``, read and deleted.  From it:
each device operation (kernel, copy, memset) with its duration; the
busy time, the union of device operations inside the window span
(``gpubench.window``); the idle gaps, each labelled by the innermost
host event (a benchmark span, a profiler CPU op or a CUDA runtime call)
under way at the gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import Counter

import torch

WINDOW = "gpubench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function"}


def span(name: str):
    """A benchmark span, seen in the trace as a user annotation."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(device: torch.device, out: dict):
    """Profile the block; ``out["trace"]`` is then its :class:`Trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events)


def short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("void ").strip()


class Trace:
    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW} span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = [(e["cat"], e["name"], float(e["ts"]), float(e["dur"]))
                       for e in xs if e.get("cat") in DEVICE_CATS
                       and self.t0 <= float(e["ts"]) < self.t1]
        self.kernels = [(name, ts, dur) for cat, name, ts, dur in self.device
                        if cat == "kernel"]
        self._host = self._sorted(e for e in xs if e.get("cat") in HOST_CATS)
        self._spans = self._sorted(e for e in xs
                                   if e.get("cat") == "user_annotation")
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.busy_s, self.gaps = self._busy_and_gaps()

    @staticmethod
    def _sorted(events):
        rows = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events)
        return [r[0] for r in rows], rows

    def _busy_and_gaps(self):
        spans = sorted((ts, min(ts + dur, self.t1))
                       for _, _, ts, dur in self.device)
        busy, gaps, at = 0.0, [], self.t0
        for a, b in spans:
            if a > at:
                gaps.append((at, a))
            if b > at:
                busy += b - max(a, at)
                at = b
        if at < self.t1:
            gaps.append((at, self.t1))
        return busy * 1e-6, gaps

    @staticmethod
    def _innermost(index, t: float, look: int):
        starts, rows = index
        i = bisect.bisect_right(starts, t)
        best = None
        for a, b, name in rows[max(0, i - look):i]:
            if b >= t and (best is None or b - a < best[0]):
                best = (b - a, name)
        return best and best[1]

    def host_at(self, t: float) -> str:
        """The innermost host event under way at ``t``: among the last
        host events begun by then, else among the benchmark's spans."""
        return (self._innermost(self._host, t, 64)
                or self._innermost(self._spans, t, 16) or "host")

    def idle_by_host(self) -> Counter:
        """Idle seconds inside the window by what the host was in."""
        out: Counter = Counter()
        for a, b in self.gaps:
            out[self.host_at(0.5 * (a + b))] += (b - a) * 1e-6
        return out

    def device_ops(self) -> Counter:
        out: Counter = Counter()
        for _, name, _, dur in self.device:
            out[short(name)] += dur * 1e-6
        return out

    def breakdown(self, top: int = 10) -> dict:
        return {
            "device_ops": [[k, v] for k, v in self.device_ops().most_common(top)],
            "idle_gaps": [[k, v] for k, v in self.idle_by_host().most_common(top)],
        }
