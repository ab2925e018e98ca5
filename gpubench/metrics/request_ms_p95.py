"""request_ms_p95: the 95th percentile (``statistics.quantiles(n=20,
method="inclusive")``) of every request's latency in the window, from the
call into the port until the answer is on the host."""
import statistics


def read(run):
    lat = sorted(r.seconds for r in run.records)
    if not lat:
        return None
    if len(lat) == 1:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
