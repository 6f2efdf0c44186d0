"""The flash forward kernel's share of its roofline in the window: each
call's bound is ``yardstick.flash_fwd_cost`` of its (BH, N, D) and dtype
(``Run.roofline_pct``)."""


def read(run):
    return run.roofline_pct("flash_fwd")
