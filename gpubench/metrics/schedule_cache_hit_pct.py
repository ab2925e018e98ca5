"""schedule_cache_hit_pct: the share of the port's schedule-cache
lookups over the window that found the compiled schedule,
``runtime.simulator`` ``SCHEDULE_CACHE_HITS`` over hits and misses."""
from gpubench import program

COUNTERS = program.present(["runtime.simulator:SCHEDULE_CACHE_HITS",
                            "runtime.simulator:SCHEDULE_CACHE_MISSES"])


def read(run):
    if len(COUNTERS) < 2:
        return None
    hits, misses = (run.counters[c] for c in COUNTERS)
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
