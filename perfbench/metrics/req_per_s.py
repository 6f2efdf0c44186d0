"""Full four-image answers completed in the window, over its seconds."""


def read(run):
    return run.done_in(run.t_start, run.t_end) / run.seconds
