"""Mean wait of a request in the batcher's queue before its batch ran
(``MicroBatcher.wait_ms``), over the window."""


def read(run):
    if not run.batcher or not run.batcher["wait_ms"]:
        return None
    waits = run.batcher["wait_ms"]
    return sum(waits) / len(waits)
