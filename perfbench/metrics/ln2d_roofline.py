"""The LayerNorm2d kernel's share of its roofline in the window: each call's
bound is its bytes, ``yardstick.ln2d_cost`` (``Run.roofline_pct``)."""


def read(run):
    return run.roofline_pct("ln2d")
