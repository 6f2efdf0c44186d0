"""Requests a batch in the window, by the batcher's own counts."""


def read(run):
    if not run.batcher or not run.batcher["batches"]:
        return None
    return run.batcher["requests"] / run.batcher["batches"]
