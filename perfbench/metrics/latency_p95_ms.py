"""95th percentile (nearest rank) of every request of the window; a failed
request counts as infinite."""

from perfbench.harness import quantile_ms


def read(run):
    return quantile_ms(run.latency_ms(), 0.95)
