"""The engine's wall a request, per-path mode: the sum over the four paths
of the mean of ``InferenceEngine.path_ms`` in the window (the batched engine
records none)."""


def read(run):
    if not all(run.path_ms.get(p) for p in ("diffusion", "nafnet", "expert", "hybrid")):
        return None
    return sum(sum(v) / len(v) for v in run.path_ms.values())
