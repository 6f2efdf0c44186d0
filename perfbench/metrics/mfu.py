"""The whole request's share of the card's peak, in %: for each request
answered in the traced window, its dense FLOPs at batch 1 (no padding rows)
over the peak of their precision (UNet evals bf16, the rest TF32), summed,
over the window's seconds (``yardstick.request_flops``)."""

from perfbench import yardstick


def read(run):
    if run.trace is None or not run.flops:
        return None
    n = run.done_in(run.t_start, run.t_end)
    return 100.0 * yardstick.request_peak_seconds(run.flops) * n / run.trace["window_s"]
