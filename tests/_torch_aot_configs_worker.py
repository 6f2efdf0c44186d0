"""The port's side of ``tests/test_torch_aot_configs.py``'s round trip, in a
process of its own (imports no JAX): an eager engine at
``tests/_torch_aot_worker.py``'s ``_small`` widths with static int8,
batching at bucket 2 and the load-adaptive turbo tier, on the CPU, seeded
weights; two of its pins (``diffusion`` and ``turbo@hybrid`` at batch 2)
compiled by ``pin_all`` into the job's empty pin directory, then loaded by
a second ``pin_all``; each program, cold and warm, and the eager path run on
the job's input with the engine's packed state.

Writes the outputs and both ``pin_all`` reports: ``python
tests/_torch_aot_configs_worker.py JOB.json``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from midd_tpu_torch.ops import qconv  # noqa: E402
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine  # noqa: E402
from midd_tpu_torch.utils import compile_cache as cc  # noqa: E402
from tests._torch_aot_worker import SMALL  # noqa: E402

INT8 = dict(quantize_int8="static", batching=True, batch_buckets=(2,), adaptive_turbo=True)
PINNED = ("diffusion", "turbo@hybrid")


def int8_config(**kw) -> EngineConfig:
    """``SMALL`` with static int8, batching at bucket 2 and adaptive turbo,
    seeded weights."""
    return EngineConfig(**{**SMALL, "ckpt_dir": "/nonexistent", **INT8, **kw})


def toy_qconv_build(scale: float = 2.0):
    """(module, example args) of a one-``QuantConv2d`` static toy whose
    weights and scale ride in a packed state, as the engine's pins take
    theirs (a picklable ``pin_all`` build)."""
    from midd_tpu_torch.serve.engine import _Pinned

    conv = qconv.QuantConv2d(4, 8, 3, mode="static")
    torch.manual_seed(0)
    torch.nn.init.normal_(conv.weight)
    qconv.load_qscales(conv, {"": torch.tensor(scale)})
    models = torch.nn.ModuleDict({"conv": conv})
    flats, layout = InferenceEngine._pack(
        {k: t.detach() for k, t in (*models.named_parameters(), *models.named_buffers())})
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(np.float32))
    return _Pinned(lambda a: models["conv"](a), models, layout), (flats, x)


def main(job_path: str) -> None:
    with open(job_path) as f:
        job = json.load(f)
    engine = InferenceEngine(int8_config(cache_dir=job["cache_dir"]))
    try:
        flats, jobs = engine._pin_jobs((2,), job["aot_dir"])
        chosen = [j for name, _, j in jobs if name in PINNED]
        x = torch.from_numpy(np.load(job["input"]))
        reports, outs = {}, {}
        for key in ("cold", "warm"):
            results = cc.pin_all(chosen, device=engine.device)
            reports[key] = [dict(info, loaded=loaded) for _, loaded, info in results]
            with torch.inference_mode():
                for name, (program, _, _) in zip(PINNED, results):
                    outs[f"{key}/{name}"] = program(flats, x).numpy()
        with torch.inference_mode():
            for name in PINNED:
                table = engine._turbo_paths if name.startswith("turbo@") else engine._paths
                outs[f"eager/{name}"] = table[name.split("@")[-1]](x).numpy()
        reports["pins"] = [os.path.basename(path) for path, _, _ in chosen]
        reports["calibration_ms"] = sorted(engine.calibration_ms)
    finally:
        engine.close()
    np.savez(job["outputs"], **outs)
    with open(job["reports"], "w") as f:
        json.dump(reports, f)


if __name__ == "__main__":
    main(sys.argv[1])
