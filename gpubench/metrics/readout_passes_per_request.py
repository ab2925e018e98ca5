"""readout_passes_per_request: the port's dense readout passes over a
whole state's planes (``ops.sampling`` ``READOUT_PASSES``) over the
window, per completed request."""
from gpubench import program

COUNTERS = program.present(["ops.sampling:READOUT_PASSES"])


def read(run):
    if not COUNTERS or not run.requests:
        return None
    return run.counters[COUNTERS[0]] / run.requests
