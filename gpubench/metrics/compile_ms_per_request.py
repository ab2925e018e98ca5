"""compile_ms_per_request: host milliseconds in the port's schedule
compiles, its ``qst.compile`` spans (a ``build_*_fn`` that missed the
schedule cache: the schedule, then its operands to the device), inside
the traced window, per completed request."""
from gpubench import program


def read(run):
    return program.ms_per_request(run, lambda name: name == "qst.compile")
