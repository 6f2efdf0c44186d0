"""Median latency of every request of the window (a failed one counts as
infinite, so a median that falls on one is not reported)."""

from perfbench.harness import quantile_ms


def read(run):
    return quantile_ms(run.latency_ms(), 0.50)
