"""The HTTP shell and codec's share of a request: the client's mean wall
from send to answer, less the mean span of ``InferenceEngine.process_all``
(timed by the harness around the engine's method) over the window. What
remains is the server's parsing, PNG decode and resize, JSON and the
socket."""


def read(run):
    walls = [r["done"] - r["send"] for r in run.records if r["ok"]]
    spans = [b - a for a, b in run.spans.get("process_all", []) if run.t_start <= a < run.t_end]
    if not walls or not spans:
        return None
    return 1e3 * (sum(walls) / len(walls) - sum(spans) / len(spans))
