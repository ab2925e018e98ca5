"""plain_gates_per_request: plain torch gates (``ops/dense.GATE_CALLS``)
over the window, per completed request."""

COUNTERS = ["ops.dense:GATE_CALLS"]


def read(run):
    if not run.requests:
        return None
    return run.counters["ops.dense:GATE_CALLS"] / run.requests
