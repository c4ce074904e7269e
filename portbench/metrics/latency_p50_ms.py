"""latency_p50_ms (ms, host clock): the median over every request that
returned within the window, from the engine call to its tables on the
host."""

from portbench import stats


def read(run):
    return stats.percentile(run.latencies, 50) * 1e3 if run.latencies else None
