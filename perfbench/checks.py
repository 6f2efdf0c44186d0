"""Whether the window's answers are right: a sample of them, drawn from the
seed by the load generator, against the plain reference.

The reference (``perfbench/reference``) gets the same checkpoints, drawn
again from the seed, and the same uploaded bytes, works out the four
answers in fp32 with TF32 off, and encodes them as the service does. For
each path the number compared is the worst, over the sample, of the share
of pixels (%) at which the served PNG and the reference's differ by 2
levels or more; it has to stay within the cell's limit
(``perfbench/workloads/<cell>.json``, ``limits``; a path the cell gives no
limit is reported in ``detail`` and not compared). Sound runs differ from
the fp32 reference by rounding, which moves most pixels by 0 or 1 level;
the control and the faults move many by more (PERF.md gives the readings
each limit was set from). The mean difference is reported beside it. A
request that failed or never came within a minute of the close is counted
too, against a limit of 0. An answer at the wrong size reads 100%.

The hybrid at 1024x1024 is followed in two stages as well, where the cell
gives them limits (``hybrid_rollout``, ``hybrid_fusion``): its answer is the
fusion of its rollout, NAFNet and router, and the fusion's gain on the
rollout varies with the seed's weights, so the rounding of the bf16 rollout
reaches the answer on some seeds as far as the control does on others
(PERF.md). The harness keeps the hybrid path's own rollout output, as the
program computed it, with its input (``harness.HybridState``); for each
checked answer, the call whose input is the answer's upload and which ran
between its send and its answer is found, and

- ``hybrid_rollout``: that rollout, encoded as the service encodes an
  answer, against the reference's rollout (the start, as the diffusion path
  is held);
- ``hybrid_fusion``: the served hybrid answer against the reference's
  fusion of the reference's NAFNet and router outputs and that rollout (the
  stage, from the program's own state).

A checked answer whose call is not found reads 100% on both.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from perfbench.reference.serve import PATHS

MATCH_TOL = 0.5 / 255  # mean |input - upload decoded| of the call that served it (the same decode gives 0)
NOT_FOUND = {"mean": 255.0, "ge2": 100.0, "ge3": 100.0}


def _decode(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("L"))


def levels(port: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """Mean absolute difference in levels, and the shares of pixels (%) off
    by 2 and by 3 levels or more."""
    if port.shape != ref.shape:
        return {"mean": 255.0, "ge2": 100.0, "ge3": 100.0}
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    return {"mean": float(d.mean()), "ge2": 100.0 * float((d >= 2).mean()), "ge3": 100.0 * float((d >= 3).mean())}


def _state_of(record: Dict, x, calls) -> Optional[object]:
    """The rollout output (1, 1, S, S) of the hybrid call that served
    ``record``: among the calls made between its send and its answer, the
    row whose input is ``x``; None if there is none."""
    best, out = MATCH_TOL, None
    for t, noisy, hq in calls:
        if record["done"] is None or not record["send"] <= t <= record["done"]:
            continue
        d = (noisy.to(x.device, x.dtype).reshape(noisy.shape[0], -1) - x.reshape(1, -1)).abs().mean(1)
        i = int(d.argmin())
        if float(d[i]) <= best:
            best, out = float(d[i]), hq[i:i + 1]
    return out


def compare(cfg: Dict, seed: int, wl: Dict, records: List[Dict], bodies: List[bytes], device: str,
            n_failed: int, hybrid_state: Optional[List] = None) -> Dict:
    """{"correct", "checks": {name: {"value", "limit"}}, "detail"}. ``records``
    are the checked requests' records, ``bodies`` their answers, and
    ``hybrid_state`` the hybrid calls the harness kept (None: not followed)."""
    import torch

    from perfbench import inputs, weights
    from perfbench.reference import models as ref
    from perfbench.reference import serve

    staged = hybrid_state is not None
    got = [json.loads(b) for b in bodies]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        models = ref.load(cfg, weights.draw(cfg, seed, device), device)
        want = serve.answer(models, cfg, [inputs.upload(seed, r["upload"], cfg["img_size"], wl["uploads"])
                                          for r in records], device, rows=wl["reference_rows"], stages=staged)
        follow = []
        for r, g, w in zip(records, got, want) if staged else ():
            hq = _state_of(r, w["x"], hybrid_state)
            if hq is None:
                follow.append((NOT_FOUND, NOT_FOUND))
                continue
            hq = hq.to(device, torch.float32)
            own = serve.encode(hq.clamp(0, 1)[0, 0].cpu().numpy(), w["original"])
            fused = serve.encode(serve.fuse(models, w["fast"], hq, w["mask"])[0, 0].cpu().numpy(), w["original"])
            follow.append((levels(own, w["diffusion"]), levels(_decode(g["hybrid"]), fused)))
        del models
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    names = PATHS + (("hybrid_rollout", "hybrid_fusion") if staged else ())
    worst = {p: {"mean": 0.0, "ge2": 0.0, "ge3": 0.0} for p in names}
    for i, (g, ref_answer) in enumerate(zip(got, want)):
        read = {p: levels(_decode(g[p]), ref_answer[p]) for p in PATHS}
        if staged:
            read["hybrid_rollout"], read["hybrid_fusion"] = follow[i]
        for p, lv in read.items():
            for k, v in lv.items():
                worst[p][k] = max(worst[p][k], v)
    checks = {"failed": {"value": n_failed, "limit": 0}}
    checks.update({f"{p}_off2_pct": {"value": worst[p]["ge2"], "limit": limit} for p, limit in wl["limits"].items()})
    correct = bool(bodies) and all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "checks": checks, "detail": worst}
