"""contract_ms_per_request: host milliseconds in the port's circuit
contract, its ``qst.contract.validate`` and ``qst.contract.hash`` spans
(a span inside another counted once), inside the traced window, per
completed request."""
from gpubench import program


def read(run):
    return program.ms_per_request(
        run, lambda name: name.startswith("qst.contract."))
