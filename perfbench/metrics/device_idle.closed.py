"""Share of the traced window, in %, in which no operation ran on the card
(the union of the kernels', copies' and sets' intervals), closed loop."""


def read(run):
    return run.idle_pct()
