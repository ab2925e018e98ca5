"""passes_per_request: kernel launches and plain twin calls of the four
kernel modules, plus plain torch gates (``ops/dense.GATE_CALLS``), over
the window, per completed request."""

COUNTERS = [f"ops.{m}_kernels:{c}" for m in ("panel", "diag", "pair", "bitperm")
            for c in ("LAUNCHES", "PLAIN_CALLS")] + ["ops.dense:GATE_CALLS"]


def read(run):
    if not run.requests:
        return None
    return sum(run.counters[c] for c in COUNTERS) / run.requests
