"""readout_ms_per_request: the host-clock span from the request's state
being ready on the card (synchronised, traced runs only) to its answer
on the host, summed over the window, per completed request."""


def read(run):
    if not run.readout_s:
        return None
    return 1e3 * sum(run.readout_s) / len(run.readout_s)
