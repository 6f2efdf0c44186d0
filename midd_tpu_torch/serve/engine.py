"""Serving engine of the port (counterpart of ``midd_tpu/serve/engine.py``):
loads the four model families, answers a request on all four paths with
per-path failure isolation, and records per-path latency. Optionally it
coalesces concurrent requests into batches (``batching``, with bounded
admission and load-adaptive turbo tiers: ``serve/batching.py``) and computes
all four paths of a request in one fused function that shares the hybrid's
backends with the standalone paths where their weights are the same
(``fused_request``).

Checkpoint sources per model: ``<ckpt_dir>/<name>.pth`` (a reference-format
torch file, loaded with ``load_state_dict``), else seeded demo weights. An
orbax directory ``<ckpt_dir>/<name>/`` raises: reading those is ROADMAP.md
queue 1 item 9. A ``sees_expert`` hybrid feeds its expert branch from
``<ckpt_dir>/expert_ftl2.pth`` when that file exists, else from the
standalone expert.

``use_flash_attention`` picks the UNets' attention (None: flash on the card,
the exact reference on the CPU). ``quantize_int8`` runs the diffusion UNets'
ResBlock and downsampler convolutions in int8 (``ops/qconv.py``): per-call
scales (True or "dynamic"), or scales calibrated at startup over seeded
phantom rollouts ("static", the server's ``--int8``).

Left out, so asking for them fails: orbax checkpoints (queue 1 item 9),
dp/tp/sp parallel serving (item 15), AOT pinning and the persistent
compilation cache (item 16), and the NAFNet s2d layout (item 17).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from midd_tpu_torch import config
from midd_tpu_torch.benchmarks.xray_bench import make_phantoms
from midd_tpu_torch.diffusion.sampler import denoise
from midd_tpu_torch.diffusion.schedule import Schedule, make_schedule, timestep_sequence
from midd_tpu_torch.models.blocks import init_weights, with_compute_dtype
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import FusionModule, NoiseAnalyzer, hybrid_forward
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops.qconv import calibrate_unet_rollout, load_qscales, with_quant_mode
from midd_tpu_torch.serve.batching import MicroBatcher
from midd_tpu_torch.serve.codec import tensor_to_base64_png
from midd_tpu_torch.train.data import NOISE_FNS

MODEL_NAMES = ("diffusion", "nafnet", "expert", "hybrid")
STUDIED_SCHEDULE = (0, 2, 6, 7)  # the gated refresh schedule of the 8-step rollout


def _log(event: str, **fields: Any) -> None:
    payload = {"ts": round(time.time(), 3), "component": "engine", "event": event, **fields}
    print(json.dumps(payload), file=sys.stderr, flush=True)


@dataclass
class EngineConfig:
    img_size: int = config.SERVE_IMG_SIZE
    diffusion_steps: int = config.SERVE_DIFFUSION_STEPS  # run.py:107
    hybrid_diffusion_steps: int = 8  # run.py:72-73
    ckpt_dir: str = "checkpoints"
    # whole-engine compute dtype (``--bf16``); None = fp32
    compute_dtype: Optional[torch.dtype] = None
    # the UNets' attention: flash (True) or the exact reference (False);
    # None = flash on a CUDA device, exact on the CPU
    use_flash_attention: Optional[bool] = None
    warmup: bool = True
    nafnet_cfg: Any = config.SERVE_NAFNET
    diffusion_cfg: Any = config.SERVE_DIFFUSION
    expert_cfg: Any = config.SERVE_EXPERT
    router_cfg: Any = field(default_factory=config.RouterConfig)
    fusion_cfg: Any = field(default_factory=config.FusionConfig)
    schedule_cfg: Any = config.SERVE_SCHEDULE
    # standalone rollout eps setting: "auto" (the studied (0,2,6,7) schedule
    # at 8 requested steps, exact otherwise), an int k (eps every k-th step;
    # 1 = exact) or a tuple of refresh indices
    turbo_eps_reuse: Any = "auto"
    # hybrid rollout eps setting; None = auto ((0,2,6,7) at 8 steps, else 2)
    hybrid_turbo_eps_reuse: Optional[Any] = None
    # UNet evals in bf16 (fp32 norms and posterior update); no-op under compute_dtype
    diffusion_eval_bf16: bool = True
    hybrid_rollout_bf16: bool = True
    device: str = "cuda"
    # coalesce concurrent requests into batches of these sizes (a batch is
    # padded up to the next bucket); "auto": (1, 2, 4, 8) up to 256², else (1,)
    batching: bool = False
    batch_buckets: Any = "auto"
    batch_max_wait_ms: float = 4.0
    # all four paths of a request in one function: when the hybrid holds only
    # router and fusion weights, its NAFNet output (and, with the same steps,
    # eps setting and eval precision, its rollout) is the standalone path's.
    # None = off; a fused call that raises falls back to the per-path ones
    fused_request: Optional[bool] = None
    # with batching: when adaptive_queue_depth requests still wait after a
    # batch was collected, the diffusion and hybrid paths run these eps
    # settings for that batch (a schedule that does not fit the rollout
    # falls back to k = 2)
    adaptive_turbo: bool = False
    adaptive_queue_depth: int = 3
    adaptive_diffusion_eps: Any = (0, 2, 7)
    adaptive_hybrid_eps: Any = (0, 2, 7)
    # bounded admission: more waiting requests than this are refused
    # (QueueFull; the server answers 503). None = unbounded
    max_queue_depth: Optional[int] = None
    # int8 convolutions in the diffusion UNets (standalone and hybrid, every
    # eval precision); not exact. False, True / "dynamic" (per-call scales)
    # or "static" (scales calibrated once at startup: 2 phantoms x the
    # three noise families, fp32 rollouts of the served step count)
    quantize_int8: Any = False


def _eps_kwargs(setting) -> Dict[str, Any]:
    if isinstance(setting, (tuple, list)):
        return {"eps_refresh_idx": tuple(int(i) for i in setting)}
    return {"eps_reuse": int(setting)}


def _sched_fits(setting, sched: Schedule, steps: int) -> bool:
    if not isinstance(setting, (tuple, list)):
        return True
    return max(setting) < len(timestep_sequence(sched.noise_steps, steps))


def calibration_batches(img_size: int, device) -> list:
    """The static-int8 calibration set, as the JAX engine makes it: 2
    procedural phantoms under each of the three reference noise families
    (cddpm/cddpmTrain.py:3), one numpy generator seeded 0 across them; three
    (2, 1, S, S) fp32 batches on ``device``."""
    clean = make_phantoms(2, img_size, seed=123)
    rng = np.random.default_rng(0)
    return [
        torch.from_numpy(np.stack([np.clip(fn(c, rng), 0.0, 1.0) for c in clean]).astype(np.float32))
        .permute(0, 3, 1, 2).to(device)
        for fn in NOISE_FNS.values()
    ]


def _demo_generator(name: str) -> torch.Generator:
    # stable across processes (Python's str hash is salted per process)
    return torch.Generator().manual_seed(zlib.crc32(name.encode()) % (2**31))


class InferenceEngine:
    def __init__(self, cfg: EngineConfig = EngineConfig()):
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "EngineConfig.device is cuda but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        if cfg.quantize_int8 not in (False, True, "dynamic", "static"):
            raise ValueError(
                f"quantize_int8 must be False, True, 'dynamic' or 'static', got {cfg.quantize_int8!r}"
            )
        if cfg.use_flash_attention is None:
            cfg = dataclasses.replace(cfg, use_flash_attention=self.device.type == "cuda")
        self.cfg = cfg
        # static int8: each calibrated UNet's scales and calibration time
        self.int8_scales: Dict[str, Dict[str, torch.Tensor]] = {}
        self.calibration_ms: Dict[str, float] = {}
        self._pth_cache: Dict[str, Dict] = {}
        self.meta: Dict[str, Dict] = {}
        self.loaded: Dict[str, bool] = {n: False for n in MODEL_NAMES}
        self.fns: Dict[str, Callable[[np.ndarray], np.ndarray]] = {}
        self.path_ms: Dict[str, Deque[float]] = {
            n: collections.deque(maxlen=256) for n in MODEL_NAMES
        }
        self._device = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-device")
        self._fused_lock = threading.Lock()
        self._fused_failures = 0
        self.batcher: Optional[MicroBatcher] = None
        self._build()

    # -- checkpoint plumbing -------------------------------------------------

    def _pth(self, name: str) -> Optional[Dict]:
        path = os.path.join(self.cfg.ckpt_dir, name)
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path!r} is an orbax checkpoint directory; the port reads "
                f"<name>.pth files only (orbax I/O: ROADMAP.md queue 1 item 9)"
            )
        if not os.path.exists(path + ".pth"):
            return None
        if name not in self._pth_cache:
            self._pth_cache[name] = torch.load(
                path + ".pth", map_location="cpu", weights_only=False
            )
        return self._pth_cache[name]

    def _peek_meta(self, name: str) -> Dict:
        ckpt = self._pth(name)
        if ckpt is None:
            return {}
        return {k: v for k, v in ckpt.items() if not k.endswith("state_dict")}

    def _place(self, build: Callable[[], nn.Module], state_dict=None,
               generator: Optional[torch.Generator] = None) -> nn.Module:
        """Build a model on the engine's device with the given weights (or
        seeded demo weights), in eval mode."""
        with torch.device("meta"):
            model = build()
        model = model.to_empty(device=self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        else:
            init_weights(model, generator)
        return model.eval().requires_grad_(False)

    def _load(self, name: str, build: Callable[[], nn.Module]) -> nn.Module:
        ckpt = self._pth(name)
        if ckpt is None:
            self.meta[name] = {"demo_weights": True}
            return self._place(build, generator=_demo_generator(name))
        self.meta[name] = self._peek_meta(name)
        return self._place(build, ckpt.get("model_state_dict", ckpt))

    @staticmethod
    def _diffusion_cfg_from_meta(meta: Dict, default):
        """Diffusion arch from checkpoint metadata: flattened (trainer
        saves) or nested under ``diffusion_params`` (hybrid saves)."""
        d = meta.get("diffusion_params") or meta
        if "model_channels" not in d:
            return default
        return config.DiffusionUNetConfig(
            in_channels=int(d.get("in_channels", default.in_channels)),
            model_channels=int(d["model_channels"]),
            channel_mult=tuple(d.get("channel_mult", default.channel_mult)),
            num_res_blocks=int(d.get("num_res_blocks", default.num_res_blocks)),
            attention_resolutions=tuple(
                d.get("attention_resolutions", default.attention_resolutions)
            ),
            time_emb_dim=int(d.get("time_emb_dim", default.time_emb_dim)),
            skip_mode=d.get("skip_mode", default.skip_mode),
        )

    @staticmethod
    def _router_cfg_from_meta(meta: Dict, default):
        d = meta.get("router_params") or {}
        if "base_c" not in d:
            return default
        return config.RouterConfig(
            in_c=int(d.get("in_c", default.in_c)),
            out_c=int(d.get("out_c", default.out_c)),
            base_c=int(d["base_c"]),
        )

    @staticmethod
    def _fusion_cfg_from_meta(meta: Dict, default):
        d = meta.get("fusion_params") or {}
        if "base_c" not in d:
            return default
        return config.FusionConfig(
            in_c=int(d.get("in_c", default.in_c)),
            out_c=int(d.get("out_c", default.out_c)),
            base_c=int(d["base_c"]),
            residual=bool(d.get("residual", default.residual)),
            sees_expert=bool(d.get("sees_expert", default.sees_expert)),
        )

    @staticmethod
    def _nafnet_cfg_from_meta(meta: Dict, default):
        if "width" not in meta:
            return default
        return config.NAFNetConfig(
            width=int(meta.get("width", 32)),
            middle_blk_num=int(meta.get("middle_blk_num", 8)),
            enc_blk_nums=tuple(meta.get("enc_blk_nums", (2, 2, 4, 6))),
            dec_blk_nums=tuple(meta.get("dec_blk_nums", (2, 2, 2, 2))),
        )

    def _unet(self, unet_cfg) -> Callable[[], nn.Module]:
        """Builder of a served UNet: the engine's attention path and int8
        mode ("dynamic" or "static"; static until calibrated has no scales)."""
        qmode = "static" if self.cfg.quantize_int8 == "static" else bool(self.cfg.quantize_int8)
        return lambda: UNetDiffusion(unet_cfg, use_flash=self.cfg.use_flash_attention, quant=qmode)

    def _calibrate(self, name: str, unet: nn.Module, schedule: Schedule, steps: int) -> None:
        """Static int8: record each int8 conv's activation abs-max over fp32
        rollouts of ``steps`` steps on ``calibration_batches`` into ``unet``."""
        batches = calibration_batches(self.cfg.img_size, self.device)
        t = time.time()
        scales = calibrate_unet_rollout(with_quant_mode(unet, "calibrate"), schedule, batches, steps)
        load_qscales(unet, scales)
        self.int8_scales[name] = scales
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_ms[name] = (time.time() - t) * 1e3
        _log("int8_calibration", model=name, latency_ms=round(self.calibration_ms[name], 2),
             steps=steps, batches=len(batches))

    def _load_hybrid(self, router_cfg, fusion_cfg, naf_cfg, unet_cfg) -> Dict[str, nn.Module]:
        """Hybrid groups from one ``hybrid.pth`` whose state_dict carries
        ``nafnet.``/``diffusion_unet.``/``router.``/``fusion.`` prefixes.
        Groups the file lacks (a trainer save holds router and fusion only)
        are left out, and the caller uses the standalone backends. Demo mode
        builds all four groups."""
        builders = {
            "nafnet": lambda: EnhancedNAFNet(naf_cfg),
            "diffusion_unet": self._unet(unet_cfg),
            "router": lambda: NoiseAnalyzer(router_cfg),
            "fusion": lambda: FusionModule(fusion_cfg),
        }
        ckpt = self._pth("hybrid")
        if ckpt is None:
            self.meta["hybrid"] = {"demo_weights": True}
            return {
                p: self._place(b, generator=_demo_generator(f"hybrid/{p}"))
                for p, b in builders.items()
            }
        self.meta["hybrid"] = self._peek_meta("hybrid")
        sd = ckpt["model_state_dict"]
        groups = {}
        for prefix, b in builders.items():
            sub = {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
            if sub:
                groups[prefix] = self._place(b, sub)
        for required in ("router", "fusion"):
            if required not in groups:
                raise KeyError(f"hybrid checkpoint has no {required!r} weights")
        return groups

    # -- graph construction --------------------------------------------------

    def _build(self):
        cfg = self.cfg
        dt = cfg.compute_dtype
        bf16 = torch.bfloat16

        def computing(model, dtype):
            return model if dtype is None else with_compute_dtype(model, dtype)

        # Diffusion path
        diff_cfg = self._diffusion_cfg_from_meta(self._peek_meta("diffusion"), cfg.diffusion_cfg)
        unet = self._load("diffusion", self._unet(diff_cfg))
        noise_steps = int(self.meta["diffusion"].get("noise_steps", cfg.schedule_cfg.noise_steps))
        schedule = make_schedule(
            dataclasses.replace(cfg.schedule_cfg, noise_steps=noise_steps), self.device
        )
        if cfg.quantize_int8 == "static":
            self._calibrate("diffusion", unet, schedule, cfg.diffusion_steps)
        unet_eval = computing(unet, dt if dt is not None else (bf16 if cfg.diffusion_eval_bf16 else None))

        dk = cfg.turbo_eps_reuse
        if dk == "auto":
            dk = (
                STUDIED_SCHEDULE
                if cfg.diffusion_steps == 8 and _sched_fits(STUDIED_SCHEDULE, schedule, 8)
                else 1
            )
        self.diffusion_eps_reuse = dk

        def make_diffusion_fn(eps_setting):
            def fn(x):
                out = denoise(unet_eval, x, schedule, cfg.diffusion_steps, **_eps_kwargs(eps_setting))
                return out.clamp(0.0, 1.0)

            return fn

        # NAFNet and expert paths
        naf_cfg = self._nafnet_cfg_from_meta(self._peek_meta("nafnet"), cfg.nafnet_cfg)
        naf = computing(self._load("nafnet", lambda: EnhancedNAFNet(naf_cfg)), dt)
        expert = computing(self._load("expert", lambda: ExpertDenoiser(cfg.expert_cfg)), dt)

        # Hybrid path: its own backends and arch from its checkpoint
        hmeta = self._peek_meta("hybrid")
        dparams = hmeta.get("diffusion_params") or {}
        hyb_naf_cfg = self._nafnet_cfg_from_meta(hmeta.get("nafnet_params") or {}, cfg.nafnet_cfg)
        hyb_unet_cfg = self._diffusion_cfg_from_meta(dparams, unet.cfg)
        hschedule = (
            make_schedule(config.ScheduleConfig(noise_steps=int(dparams["noise_steps"])), self.device)
            if dparams.get("noise_steps")
            else schedule
        )
        fusion_cfg = self._fusion_cfg_from_meta(hmeta, cfg.fusion_cfg)
        groups = self._load_hybrid(
            self._router_cfg_from_meta(hmeta, cfg.router_cfg), fusion_cfg, hyb_naf_cfg, hyb_unet_cfg
        )
        router = computing(groups["router"], dt)
        fusion = computing(groups["fusion"], dt)
        hyb_naf = computing(groups["nafnet"], dt) if "nafnet" in groups else naf
        if "diffusion_unet" in groups:
            hyb_unet = groups["diffusion_unet"]
        else:
            hyb_unet, hschedule = unet, schedule
        share_backends = hyb_naf is naf and hyb_unet is unet
        if cfg.quantize_int8 == "static":
            # the standalone scales serve the hybrid where its weights and
            # rollout are the standalone ones; else it calibrates its own
            if hyb_unet is unet and cfg.hybrid_diffusion_steps != cfg.diffusion_steps:
                hyb_unet = copy.deepcopy(unet)
            if hyb_unet is not unet:
                self._calibrate("hybrid", hyb_unet, hschedule, cfg.hybrid_diffusion_steps)
        hyb_dt = bf16 if cfg.hybrid_rollout_bf16 else dt
        if hyb_unet is unet and hyb_dt == unet_eval.compute_dtype:
            hyb_unet_eval = unet_eval
        else:
            hyb_unet_eval = computing(hyb_unet, hyb_dt)

        # An expert-fed fusion takes a fourth input: the expert_ftl2 tree it
        # was trained beside when the directory holds one, else the
        # standalone expert. "shared" is also reported for a fusion that
        # takes no expert, as the JAX engine reports it.
        hyb_expert = None
        self.hybrid_expert_tree = "shared"
        if fusion_cfg.sees_expert:
            hyb_expert = expert
            if self._pth("expert_ftl2") is not None:
                hyb_expert = computing(self._load("expert_ftl2", lambda: ExpertDenoiser(cfg.expert_cfg)), dt)
                self.hybrid_expert_tree = "expert_ftl2"

        # The hybrid could ride the standalone rollout: same weights, same
        # schedule, same step count.
        rollout_shareable = (
            share_backends and hschedule is schedule
            and cfg.hybrid_diffusion_steps == cfg.diffusion_steps
        )
        hk = cfg.hybrid_turbo_eps_reuse
        if hk is None or hk == "auto":
            if bool(cfg.fused_request) and rollout_shareable and isinstance(dk, int) and dk <= 2:
                hk = dk  # the fused request computes that rollout anyway
            elif cfg.hybrid_diffusion_steps == 8 and _sched_fits(STUDIED_SCHEDULE, hschedule, 8):
                hk = STUDIED_SCHEDULE
            else:
                hk = 2
        self.hybrid_eps_reuse = hk

        def make_hybrid_fn(eps_setting, naf_fn=hyb_naf, rollout=None):
            def fn(x):
                out = hybrid_forward(
                    naf_fn,
                    rollout or (lambda a: denoise(hyb_unet_eval, a, hschedule, cfg.hybrid_diffusion_steps,
                                                  **_eps_kwargs(eps_setting))),
                    router,
                    fusion,
                    x,
                    expert_apply=hyb_expert,
                )
                return out.clamp(0.0, 1.0)

            return fn

        paths = {
            "diffusion": make_diffusion_fn(dk),
            "nafnet": lambda x: naf(x).clamp(0.0, 1.0),
            "expert": lambda x: expert(x).clamp(0.0, 1.0),
            "hybrid": make_hybrid_fn(hk),
        }
        self._paths = paths
        self.fns = {n: self._bind(self._paths, n) for n in paths}

        # The queue-pressure tier of the two rollout paths, each schedule
        # checked against its own path's rollout length.
        self._turbo_paths: Dict[str, Callable] = {}
        self.turbo_fns: Optional[Dict[str, Callable]] = None
        if cfg.adaptive_turbo:
            def tier_eps(setting, sched, steps):
                return setting if _sched_fits(setting, sched, steps) else 2

            self._turbo_paths = {
                "diffusion": make_diffusion_fn(tier_eps(cfg.adaptive_diffusion_eps, schedule, cfg.diffusion_steps)),
                "hybrid": make_hybrid_fn(tier_eps(cfg.adaptive_hybrid_eps, hschedule, cfg.hybrid_diffusion_steps)),
            }
            self.turbo_fns = {n: self._bind(self._turbo_paths, n) for n in self._turbo_paths}

        # The fused request computes the shared NAFNet forward and, where the
        # eps settings and the eval model match too, the rollout once.
        share_rollout = rollout_shareable and hk == dk and hyb_unet_eval is unet_eval
        self.shares = {"backends": share_backends, "rollout": share_rollout}
        self._fused_path: Optional[Callable] = None
        self.fused: Optional[Callable[[np.ndarray], Dict[str, np.ndarray]]] = None
        if cfg.fused_request:
            def fused_fn(x):
                naf_raw = naf(x)
                diff_raw = denoise(unet_eval, x, schedule, cfg.diffusion_steps, **_eps_kwargs(dk))
                hybrid = make_hybrid_fn(
                    hk,
                    naf_fn=(lambda a: naf_raw) if share_backends else hyb_naf,
                    rollout=(lambda a: diff_raw) if share_rollout else None,
                )
                return {
                    "diffusion": diff_raw.clamp(0.0, 1.0),
                    "nafnet": naf_raw.clamp(0.0, 1.0),
                    "expert": expert(x).clamp(0.0, 1.0),
                    "hybrid": hybrid(x),
                }

            self._fused_path = fused_fn
            self.fused = lambda x: self._on_device_thread(self._run_fused, x)

        s = cfg.img_size
        if cfg.batching:
            buckets = cfg.batch_buckets
            if buckets == "auto":
                buckets = (1, 2, 4, 8) if s <= 256 else (1,)
            # the batcher warms every bucket of every function, batch 1 included
            self.batcher = MicroBatcher(
                self.fns,
                buckets=tuple(int(b) for b in buckets),
                max_wait_ms=cfg.batch_max_wait_ms,
                warmup_shape=(s, s, 1) if cfg.warmup else None,
                fused_fn=self.fused,
                turbo_fns=self.turbo_fns,
                turbo_queue_depth=cfg.adaptive_queue_depth,
                max_queue_depth=cfg.max_queue_depth,
            )
        elif cfg.warmup:
            xw = np.zeros((1, s, s, 1), np.float32)
            warm = dict(self.fns)
            if self.fused is not None:
                warm["fused(all4)"] = self.fused
            for name, fn in warm.items():
                t = time.time()
                fn(xw)
                _log("warmup", model=name, latency_ms=round((time.time() - t) * 1e3, 2))

        for n in MODEL_NAMES:
            self.loaded[n] = True

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """(B, H, W, 1) NHWC numpy -> (B, 1, H, W) fp32 on the device."""
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2).to(self.device)

    @staticmethod
    def _to_host(y: torch.Tensor) -> np.ndarray:
        return y.float().permute(0, 2, 3, 1).cpu().numpy()

    def _on_device_thread(self, fn: Callable, *args):
        """Run ``fn`` on the engine's one device thread and return its result.
        All device work happens there: batches and requests are served one
        at a time, and per-thread caches (PyTorch keeps cuDNN execution
        plans per thread) stay warm across requests that arrive on new
        threads."""
        return self._device.submit(fn, *args).result()

    def _run(self, table: Dict[str, Callable], name: str, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return self._to_host(table[name](self._to_device(x)))

    def _bind(self, table: Dict[str, Callable], name: str) -> Callable[[np.ndarray], np.ndarray]:
        return lambda x: self._on_device_thread(self._run, table, name, x)

    def _run_fused(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            outs = self._fused_path(self._to_device(x))
            return {name: self._to_host(outs[name]) for name in MODEL_NAMES}

    @property
    def fused_failures(self) -> int:
        """Fused calls that raised and were answered by the per-path
        functions, batched or not."""
        batched = self.batcher.stats["fused_failures"] if self.batcher is not None else 0
        return self._fused_failures + batched

    # -- request processing --------------------------------------------------

    def _run_all(self, x: np.ndarray) -> Dict[str, Optional[np.ndarray]]:
        """The four paths on the device thread; a path that raises gives None."""
        outs: Dict[str, Optional[np.ndarray]] = {}
        with torch.inference_mode():
            xt = self._to_device(x)
            for name in MODEL_NAMES:
                try:
                    t0 = time.time()
                    outs[name] = self._to_host(self._paths[name](xt))
                    ms = (time.time() - t0) * 1e3
                    self.path_ms[name].append(ms)
                    _log("request", model=name, latency_ms=round(ms, 2))
                except Exception as e:  # noqa: BLE001  per-path isolation
                    _log("model_failed", model=name, error=repr(e))
                    outs[name] = None
        return outs

    def _outputs(self, x: np.ndarray) -> Tuple[Dict[str, Optional[np.ndarray]], str]:
        if self.batcher is not None:
            return self.batcher.process(x), "batched"  # QueueFull when admission refuses
        if self.fused is not None:
            try:
                return self.fused(x), "fused"
            except Exception as e:  # noqa: BLE001  fall back to the per-path functions
                with self._fused_lock:
                    self._fused_failures += 1
                _log("fused_failed", error=repr(e))
        return self._on_device_thread(self._run_all, x), "per_path"

    def process_all(self, x: np.ndarray, original_size) -> Dict[str, Optional[str]]:
        """All four paths with per-path failure isolation (run.py:85-101): a
        path that fails answers None and the others still answer. The PNG
        encode runs on the calling thread, beside the next request's or
        batch's device work."""
        t_start = time.time()
        outs, mode = self._outputs(x)
        results: Dict[str, Optional[str]] = {}
        for name in MODEL_NAMES:
            out = outs.get(name)
            try:
                results[name] = None if out is None else tensor_to_base64_png(out, original_size)
            except Exception as e:  # noqa: BLE001  per-path isolation
                _log("model_failed", model=name, error=repr(e))
                results[name] = None
        _log("request_all", mode=mode, latency_ms=round((time.time() - t_start) * 1e3, 2))
        return results

    def close(self) -> None:
        """Stop the batcher, then the device thread."""
        if self.batcher is not None:
            self.batcher.stop()
        self._device.shutdown(wait=True)

    def serving_mode(self) -> Dict:
        """The resolved quality levers; ``exact`` is True only when every
        gated non-exact default is off (the ``--exact`` mode)."""
        cfg = self.cfg
        dt = cfg.compute_dtype

        def _eps(s):
            return list(s) if isinstance(s, (tuple, list)) else s

        def _name(d):
            return str(d).replace("torch.", "")

        diff_eval = _name(dt) if dt is not None else ("bfloat16" if cfg.diffusion_eval_bf16 else "float32")
        hyb_eval = "bfloat16" if cfg.hybrid_rollout_bf16 else (_name(dt) if dt is not None else "float32")
        exact = (
            self.diffusion_eps_reuse == 1
            and self.hybrid_eps_reuse == 1
            and diff_eval == "float32"
            and hyb_eval == "float32"
            and dt is None
            and not cfg.quantize_int8
        )
        return {
            "exact": exact,
            "img_size": cfg.img_size,
            "steps": [cfg.diffusion_steps, cfg.hybrid_diffusion_steps],
            "diffusion_eps": _eps(self.diffusion_eps_reuse),
            "hybrid_eps": _eps(self.hybrid_eps_reuse),
            "compute_dtype": _name(dt) if dt is not None else "float32",
            "diffusion_eval_dtype": diff_eval,
            "hybrid_rollout_eval_dtype": hyb_eval,
            "quantize_int8": str(cfg.quantize_int8) if cfg.quantize_int8 else False,
            "fused_request": self.fused is not None,
            "batching": self.batcher is not None,
            "flash_attention": bool(cfg.use_flash_attention),
            "hybrid_expert_tree": self.hybrid_expert_tree,
            # the port computes the plain layouts: no NAFNet space-to-depth
            # and no stage-0 space-to-depth in the UNet (JAX reports True
            # for the latter; both are exact restructurings)
            "layout": {"nafnet_s2d": False, "unet_fused_updown": True, "unet_s2d_stage0": False},
            "adaptive_turbo": {
                "queue_depth": cfg.adaptive_queue_depth,
                "diffusion_eps": _eps(cfg.adaptive_diffusion_eps),
                "hybrid_eps": _eps(cfg.adaptive_hybrid_eps),
            } if cfg.adaptive_turbo else False,
        }

    def health(self) -> Dict:
        device = str(self.device)
        if self.device.type == "cuda":
            device = f"{device} ({torch.cuda.get_device_name(self.device)})"
        return {
            "status": "healthy",
            "device": device,
            "models_loaded": dict(self.loaded),
            "serving_mode": self.serving_mode(),
            "fused_failures": self.fused_failures,
        }
