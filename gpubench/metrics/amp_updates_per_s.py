"""amp_updates_per_s: over the requests completed in the window, the sum of
(the circuit's gates as the user wrote them x 2^n), divided by the
window's seconds on the host's clock, from its start until the request
under way at the deadline returned."""


def read(run):
    work = sum(len(r.request.circuit["gates"]) for r in run.done)
    return work * (1 << run.n) / run.window_s
