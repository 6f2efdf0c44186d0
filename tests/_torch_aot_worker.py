"""The port's side of ``tests/test_torch_compile_cache.py``'s engine round
trip, in a process of its own (imports no JAX): engines at the ``_small``
widths of ``tests/test_torch_serve.py``, exact fp32, flash attention, on the
CPU, over the job's checkpoints and pin directory:

1. a cold start on the job's schedule (every pin compiled);
2. a warm start on it (every pin loaded);
3. the eager engine on it;
4. a start on another schedule of the same step count, into the same pin
   directory (every pin compiled again, not loaded);
5. the eager engine on that schedule.

Writes each start's ``aot_report`` and each engine's outputs on the job's
input: ``python tests/_torch_aot_worker.py JOB.json``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from midd_tpu_torch import config  # noqa: E402
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine  # noqa: E402

UNET = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(1,), time_emb_dim=16)
NAF = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
# tests/test_torch_serve.py's _small, the --exact serving mode, flash attention
SMALL = dict(
    img_size=16, nafnet_cfg=config.NAFNetConfig(**NAF), diffusion_cfg=config.DiffusionUNetConfig(**UNET),
    expert_cfg=config.ExpertConfig(base_channels=8), router_cfg=config.RouterConfig(base_c=8),
    fusion_cfg=config.FusionConfig(base_c=16), warmup=False, diffusion_steps=2, hybrid_diffusion_steps=2,
    turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1, diffusion_eval_bf16=False, hybrid_rollout_bf16=False,
    use_flash_attention=True, device="cpu",
)


def main(job_path: str) -> None:
    with open(job_path) as f:
        job = json.load(f)
    x = np.load(job["input"])
    schedules = {key: config.ScheduleConfig(**kw) for key, kw in job["schedules"].items()}
    pinned = dict(aot_dir=job["aot_dir"], cache_dir=job["cache_dir"])
    runs = [("cold", "first", pinned), ("warm", "first", pinned), ("eager", "first", {}),
            ("other", "other", pinned), ("other_eager", "other", {})]
    reports, outs = {}, {}
    for key, schedule, extra in runs:
        engine = InferenceEngine(EngineConfig(**SMALL, ckpt_dir=job["ckpt_dir"],
                                              schedule_cfg=schedules[schedule], **extra))
        try:
            reports[key] = engine.aot_report
            for name in MODEL_NAMES:
                outs[f"{key}/{name}"] = engine.fns[name](x)
        finally:
            engine.close()
    np.savez(job["outputs"], **outs)
    with open(job["reports"], "w") as f:
        json.dump(reports, f)


if __name__ == "__main__":
    main(sys.argv[1])
