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
orbax directory ``<ckpt_dir>/<name>/`` (the JAX package's checkpoints)
raises: the port imports no jax, so convert it first, on a host with jax,
with ``python orbax_bridge.py to-pth <dir> <dir>.pth`` (or ``dir`` for a
whole checkpoint directory). A ``sees_expert`` hybrid feeds its expert
branch from ``<ckpt_dir>/expert_ftl2.pth`` when that file exists, else from
the standalone expert.

``use_flash_attention`` picks the UNets' attention (None: flash on the card,
the exact reference on the CPU). ``quantize_int8`` runs the diffusion UNets'
ResBlock and downsampler convolutions in int8 (``ops/qconv.py``): per-call
scales (True or "dynamic"), or scales calibrated at startup over seeded
phantom rollouts ("static", the server's ``--int8``).

``nafnet_s2d`` is accepted, so a JAX engine config reads as it is, and
changes nothing: the JAX engine then runs its NAFNets' full-resolution
stage in a space-to-depth layout, and its UNets stage 0 so unless int8
(``ops/naf_s2d.py``, ``ops/unet_s2d.py``). Those are restructurings for the
TPU's 128 lanes with the same function and parameters, not ported: the port
computes the plain layouts, and ``serving_mode()["layout"]`` says so.

``data_parallel``, ``tensor_parallel`` and ``spatial_parallel`` lay the
engine's devices (``devices``: by default every local card, or the CPU) out
as the JAX engine lays out its mesh: ``tensor_parallel`` alone takes every
device (over sp) as tp, ``spatial_parallel`` alone takes as many as the
deepest feature map has rows as sp (dp 1 either way, so batch-1 requests
work); with ``data_parallel`` the (4, 2, 1) rule of ``parallel/mesh.py``
picks tp and sp defaults to 2; ``tp_size`` and ``sp_size`` set them. An sp
larger than the deepest feature map's rows raises the JAX engine's
``ValueError``, the depth read from the architectures that the checkpoints'
metadata resolve. Each dp group holds a replica of every model, run on a
thread of its own, and takes an equal part of a batch's rows (a batch whose
rows do not divide over dp raises; under batching the buckets round up to
multiples of dp). Within a replica the layers that the tp rule splits
compute each output-channel slice on its tp device (``parallel/tp.py``),
and every convolution computes each block of its output rows on its sp
device (``parallel/sp.py``; both at once on the (sp, tp) grid); the pieces
are gathered onto the replica's first device, where everything else runs.
With one device, or no such flag, there is no mesh and nothing changes.

int8 under ``tensor_parallel`` keeps the JAX engine's order: each UNet is
calibrated whole, then split; a slice of a ``QuantConv2d`` keeps the
layer's activation scale (on the slice's device) and computes its weight
scales from its own output channels, which are the whole layer's.

``aot_dir`` pins every serving program (``_pin_executables``: each path,
and each turbo path under ``adaptive_turbo``, at each batch bucket) as an
AOTInductor package in that directory at the first start, and loads the
packages on later starts (``utils/compile_cache.py``). The hand-written
kernels run inside the programs as custom ops; the weights are program
inputs, so a pin serves any checkpoint of the same architecture. A pin's
key holds what the JAX engine's holds and, unlike it, the schedule, the
resolved model, router and fusion configs (``num_heads``, a schedule's
betas: program constants that leave the weights' shapes as they are).
``persistent_cache`` / ``cache_dir`` keep Inductor's and Triton's caches on
disk. Pinning takes a single-device engine (no mesh), as the JAX engine's
does; unlike it, the port does not refuse a one-device engine on a machine
with more cards, since a package is not tied to the process's device set.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import hashlib
import math
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils.stateless import _reparametrize_module

from midd_tpu_torch import config
from midd_tpu_torch.benchmarks.xray_bench import make_phantoms
from midd_tpu_torch.diffusion.sampler import denoise
from midd_tpu_torch.diffusion.schedule import Schedule, make_schedule, timestep_sequence
from midd_tpu_torch.models.blocks import init_weights, with_compute_dtype
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import FusionModule, NoiseAnalyzer, hybrid_forward
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops.qconv import QuantConv2d, calibrate_unet_rollout, load_qscales, with_quant_mode
from midd_tpu_torch.parallel.mesh import AXES, count_tp_sharded, mesh_layout, param_shardings
from midd_tpu_torch.parallel.sp import shard_rows
from midd_tpu_torch.parallel.tp import shard_params
from midd_tpu_torch.serve.batching import MicroBatcher
from midd_tpu_torch.serve.codec import tensor_to_base64_png
from midd_tpu_torch.train.data import NOISE_FNS
from midd_tpu_torch.utils.checkpoint import orbax_message
from midd_tpu_torch.utils.compile_cache import AotDispatch, aot_fingerprint, enable_persistent_cache, pin_all
from midd_tpu_torch.utils.logging import get_logger

MODEL_NAMES = ("diffusion", "nafnet", "expert", "hybrid")
STUDIED_SCHEDULE = (0, 2, 6, 7)  # the gated refresh schedule of the 8-step rollout
log = get_logger("engine")


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
    # the JAX engine's NAFNet space-to-depth layout: accepted and ignored,
    # the plain layout is computed (the same function and parameters)
    nafnet_s2d: bool = False
    # batch rows split over dp replicas of the models (buckets rounded up to
    # multiples of dp); a no-op on one device
    data_parallel: bool = False
    # conv and linear weights of at least tp_min_size elements split over
    # the tp devices on their output channels; composes with data_parallel
    tensor_parallel: bool = False
    tp_min_size: int = 1 << 16
    # tp size; None = every device when tensor_parallel alone (dp 1), else
    # the (4, 2, 1) rule with data_parallel
    tp_size: Optional[int] = None
    # every convolution's output rows split over the sp devices (one image
    # split: the batch-1 latency lever); composes with dp and tp. sp_size
    # None: alone, every device up to the deepest feature map's rows, else 2
    spatial_parallel: bool = False
    sp_size: Optional[int] = None
    # Inductor's and Triton's compile caches on disk (utils/compile_cache.py),
    # in cache_dir (None: the one the process set, else <repo>/.torch_cache,
    # or MIDD_TPU_TORCH_CACHE_DIR): a pin compiled again reuses the kernels
    # compiled for the last one
    persistent_cache: bool = True
    cache_dir: Optional[str] = None
    # AOT pinning: every serving program (path x batch bucket) is compiled by
    # AOTInductor into this directory at the first start and loaded on later
    # starts. Single-device engines only. Keyed by the JAX engine's fields,
    # the schedule, the resolved model configs, the state's structure and
    # the torch, CUDA and device identity; a stale or broken pin is
    # recompiled and overwritten
    aot_dir: Optional[str] = None


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


# The models (keys of a replica's model dict) that each path runs; its pin
# reads only their tensors from the packed state. A key that a replica
# lacks raises (``_pinned``); a model the configuration leaves out (None,
# the hybrid without its expert) is skipped
PATH_MODELS = {"diffusion": ("unet_eval",), "nafnet": ("naf",), "expert": ("expert",),
               "hybrid": ("hyb_naf", "hyb_unet_eval", "router", "fusion", "hyb_expert")}


class _Pinned(nn.Module):
    """A serving path as a module of ``(flats, x)`` that holds no tensor:
    ``models`` (kept out of the module's state, so that export takes no
    weight as a constant) run reparametrised by views of ``flats`` at
    ``layout``'s offsets (``InferenceEngine._pack``). ``others``, the
    replica's models that the path does not run, hold meta tensors while it
    runs: a path that read one would fail to trace, rather than take that
    model's weights as constants."""

    def __init__(self, fn: Callable, models: nn.ModuleDict, layout: Dict[str, tuple],
                 others: Optional[nn.ModuleDict] = None):
        super().__init__()
        self.fn, self.layout = fn, layout
        object.__setattr__(self, "models", models)
        others = others if others is not None else nn.ModuleDict()
        object.__setattr__(self, "others", others)
        self.poison = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                       for n, t in (*others.named_parameters(), *others.named_buffers())}

    def forward(self, flats: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        state = {name: flats[key].narrow(0, off, math.prod(shape)).view(shape)
                 for name, (key, off, shape) in self.layout.items()}
        with _reparametrize_module(self.others, self.poison, strict=True), \
                _reparametrize_module(self.models, state, tie_weights=True, strict=True):
            return self.fn(x)


def pin_module(cfg: "EngineConfig", name: str, batch: int) -> Tuple[nn.Module, tuple]:
    """The module and example inputs of the pin of path ``name`` at
    ``batch``, from an engine of ``cfg`` built in the calling process (a
    compile worker of ``utils/compile_cache.pin_all``): the same models,
    layout and path as the engine that asked for the pin. Its weights are
    the checkpoints' or the seeded ones, its static int8 scales
    placeholders (``_PinEngine``); the program takes them as inputs."""
    engine = _PinEngine(dataclasses.replace(cfg, aot_dir=None, warmup=False, batching=False,
                                            persistent_cache=False))
    return engine._pinned(name, batch)


class InferenceEngine:
    """``devices``: the devices the parallel flags lay out (the JAX engine's
    ``jax.devices()``); default every local card of ``cfg.device``'s type,
    or ``[cfg.device]`` on the CPU. A list may name one device more than
    once, so that one card or the CPU holds several dp replicas or tp
    slices."""

    def __init__(self, cfg: EngineConfig = EngineConfig(), devices: Optional[Sequence] = None):
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
        self._pth_cache: Dict[str, Dict] = {}
        self.meta: Dict[str, Dict] = {}
        self.mesh = self._layout(devices)  # sp's guard reads the checkpoints' metadata
        if self.mesh is not None:
            if cfg.aot_dir:
                raise ValueError(
                    "aot_dir requires a single-device engine: a pinned program is "
                    "compiled for one device, and the dp, tp and sp layouts split "
                    f"the models over {self.mesh.size} (mesh {self.mesh.shape})"
                )
            self.device = self.mesh[0, 0, 0]
        if cfg.persistent_cache:
            enable_persistent_cache(cfg.cache_dir)
        # per pin "{path}_b{batch}" (aot_dir only): "loaded", "secs" (the
        # start's pins together), and the pin's "load_s", or its compile
        # worker's report ("export_s", "compile_s", ...: pin_all)
        self.aot_report: Dict[str, Dict[str, Any]] = {}
        self._aot: Dict[str, Any] = {}
        self.n_tp_sharded = 0
        # static int8: each calibrated UNet's scales and calibration time
        self.int8_scales: Dict[str, Dict[str, torch.Tensor]] = {}
        self.calibration_ms: Dict[str, float] = {}
        self.loaded: Dict[str, bool] = {n: False for n in MODEL_NAMES}
        self.fns: Dict[str, Callable[[np.ndarray], np.ndarray]] = {}
        self.path_ms: Dict[str, Deque[float]] = {
            n: collections.deque(maxlen=256) for n in MODEL_NAMES
        }
        self._device = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-device")
        # one thread per dp replica (none without dp)
        self._replicas: List[ThreadPoolExecutor] = [
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"engine-dp{r}")
            for r in range(self.mesh.shape[0] if self.mesh is not None and self.mesh.shape[0] > 1 else 0)
        ]
        self._fused_lock = threading.Lock()
        self._fused_failures = 0
        self.batcher: Optional[MicroBatcher] = None
        self._build()

    def _layout(self, devices: Optional[Sequence]) -> Optional[np.ndarray]:
        """The (dp, sp, tp) array of devices of the JAX engine's mesh rule
        (``midd_tpu/serve/engine.py:420-482``), or None: no parallel flag,
        or one device."""
        cfg = self.cfg
        if devices is None:
            cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
            devices = [torch.device("cuda", i) for i in range(cards)] or [self.device]
        devices = [torch.device(d) for d in devices]
        if any(d.type != self.device.type for d in devices):
            raise ValueError(f"devices {devices} are not all of EngineConfig.device's type {self.device.type}")
        n = len(devices)
        if not (cfg.data_parallel or cfg.tensor_parallel or cfg.spatial_parallel) or n == 1:
            return None
        sp = 1
        if cfg.spatial_parallel:
            deepest = self._deepest_rows()
            sp = cfg.sp_size or (min(n, deepest) if not (cfg.data_parallel or cfg.tensor_parallel) else 2)
            if sp > deepest:
                raise ValueError(
                    f"spatial_parallel sp={sp} exceeds the deepest "
                    f"feature-map height {deepest} at img_size="
                    f"{cfg.img_size}: some shards would be empty "
                    f"(wrong results under GSPMD). Lower sp_size."
                )
        tp = 1
        if cfg.tensor_parallel:
            tp = cfg.tp_size
            if tp is None and not cfg.data_parallel:
                tp = n // sp  # dp 1: batch-1 requests work
        # spatial- or tensor-alone modes keep dp 1, even if devices idle
        return mesh_layout(n if cfg.data_parallel else sp * tp, tp, sp, ranks=devices)

    def _deepest_rows(self) -> int:
        """The deepest feature map's rows at ``img_size``, over the
        architectures that the checkpoints' metadata resolve (the NAFNets'
        encoder stages, the UNets' downsamplings, and at least the expert's
        and the router's 2), as the JAX engine's sp guard reads them."""
        cfg = self.cfg
        hmeta = self._peek_meta("hybrid")
        naf = self._nafnet_cfg_from_meta(self._peek_meta("nafnet"), cfg.nafnet_cfg)
        hyb_naf = self._nafnet_cfg_from_meta(hmeta.get("nafnet_params", {}) or {}, cfg.nafnet_cfg)
        diff = self._diffusion_cfg_from_meta(self._peek_meta("diffusion"), cfg.diffusion_cfg)
        hyb_mult = tuple((hmeta.get("diffusion_params") or {}).get("channel_mult", cfg.diffusion_cfg.channel_mult))
        n_downs = max(len(naf.enc_blk_nums), len(hyb_naf.enc_blk_nums), len(diff.channel_mult) - 1,
                      len(hyb_mult) - 1, 2)
        return max(1, cfg.img_size >> n_downs)

    @property
    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """``{"dp", "sp", "tp"}`` sizes of the mesh (the JAX engine's
        ``mesh.shape``), None without one."""
        return None if self.mesh is None else dict(zip(AXES, self.mesh.shape))

    # -- checkpoint plumbing -------------------------------------------------

    def _pth(self, name: str) -> Optional[Dict]:
        path = os.path.join(self.cfg.ckpt_dir, name)
        if os.path.isdir(path):
            raise NotImplementedError(orbax_message(path))
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
        log.latency("int8_calibration", self.calibration_ms[name] / 1e3, model=name, steps=steps,
                    batches=len(batches))

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
        # what the programs compute beyond the weights' shapes: the pin key's
        self._resolved = {
            "schedule": dataclasses.replace(cfg.schedule_cfg, noise_steps=noise_steps),
            "hybrid_noise_steps": hschedule.noise_steps,
            "diffusion": diff_cfg, "nafnet": naf_cfg, "expert": cfg.expert_cfg,
            "hybrid_diffusion": hyb_unet_cfg, "hybrid_nafnet": hyb_naf_cfg,
            "router": self._router_cfg_from_meta(hmeta, cfg.router_cfg), "fusion": fusion_cfg,
        }
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

        # The fused request computes the shared NAFNet forward and, where the
        # eps settings and the eval model match too, the rollout once.
        share_rollout = rollout_shareable and hk == dk and hyb_unet_eval is unet_eval
        self.shares = {"backends": share_backends, "rollout": share_rollout}

        def tier_eps(setting, sched, steps):
            return setting if _sched_fits(setting, sched, steps) else 2

        def make_paths(m: Dict[str, Optional[nn.Module]], schedule: Schedule, hschedule: Schedule):
            """The per-path, turbo and fused functions over one replica's
            models ``m``."""
            def make_diffusion_fn(eps_setting):
                def fn(x):
                    out = denoise(m["unet_eval"], x, schedule, cfg.diffusion_steps, **_eps_kwargs(eps_setting))
                    return out.clamp(0.0, 1.0)

                return fn

            def make_hybrid_fn(eps_setting, naf_fn=m["hyb_naf"], rollout=None):
                def fn(x):
                    out = hybrid_forward(
                        naf_fn,
                        rollout or (lambda a: denoise(m["hyb_unet_eval"], a, hschedule, cfg.hybrid_diffusion_steps,
                                                      **_eps_kwargs(eps_setting))),
                        m["router"],
                        m["fusion"],
                        x,
                        expert_apply=m["hyb_expert"],
                    )
                    return out.clamp(0.0, 1.0)

                return fn

            paths = {
                "diffusion": make_diffusion_fn(dk),
                "nafnet": lambda x: m["naf"](x).clamp(0.0, 1.0),
                "expert": lambda x: m["expert"](x).clamp(0.0, 1.0),
                "hybrid": make_hybrid_fn(hk),
            }
            # The queue-pressure tier of the two rollout paths, each schedule
            # checked against its own path's rollout length.
            turbo = {
                "diffusion": make_diffusion_fn(tier_eps(cfg.adaptive_diffusion_eps, schedule, cfg.diffusion_steps)),
                "hybrid": make_hybrid_fn(tier_eps(cfg.adaptive_hybrid_eps, hschedule, cfg.hybrid_diffusion_steps)),
            } if cfg.adaptive_turbo else {}

            def fused_fn(x):
                naf_raw = m["naf"](x)
                diff_raw = denoise(m["unet_eval"], x, schedule, cfg.diffusion_steps, **_eps_kwargs(dk))
                hybrid = make_hybrid_fn(
                    hk,
                    naf_fn=(lambda a: naf_raw) if share_backends else m["hyb_naf"],
                    rollout=(lambda a: diff_raw) if share_rollout else None,
                )
                return {
                    "diffusion": diff_raw.clamp(0.0, 1.0),
                    "nafnet": naf_raw.clamp(0.0, 1.0),
                    "expert": m["expert"](x).clamp(0.0, 1.0),
                    "hybrid": hybrid(x),
                }

            return paths, turbo, fused_fn if cfg.fused_request else None

        # The models the paths run, laid out as the JAX engine lays out its
        # weights over the mesh: one replica of them a dp group, each with
        # the layers that the tp rule splits sharded over its tp devices,
        # then every convolution's rows over its sp devices (cast and
        # int8-calibrated first, so that the pieces hold the cast weights and
        # the calibrated scales).
        models = {"unet_eval": unet_eval, "hyb_unet_eval": hyb_unet_eval, "naf": naf, "hyb_naf": hyb_naf,
                  "expert": expert, "hyb_expert": hyb_expert, "router": router, "fusion": fusion}
        replicas = [models]
        if self.mesh is not None:
            dp, sp, tp = self.mesh.shape
            # the weight trees whose split leaves the JAX engine counts
            trees = [unet, naf, expert, router, fusion] + [groups[g] for g in ("nafnet", "diffusion_unet")
                                                           if g in groups]
            if self.hybrid_expert_tree == "expert_ftl2":
                trees.append(hyb_expert)
            self.n_tp_sharded = sum(count_tp_sharded(param_shardings(t, tp, cfg.tp_min_size)) for t in trees)
            replicas += [copy.deepcopy(models) for _ in range(1, dp)]
            for r, ms in enumerate(replicas):
                tp_devices = list(self.mesh[r, 0])
                for mod in {id(mod): mod for mod in ms.values() if mod is not None}.values():
                    mod.to(tp_devices[0])
                    if tp > 1:
                        shard_params(mod, tp_devices, cfg.tp_min_size)
                    if sp > 1:
                        shard_rows(mod, list(self.mesh[r]))
        self.replicas: List[Dict[str, Optional[nn.Module]]] = replicas
        built = []
        for r, ms in enumerate(replicas):
            lead = self.device if self.mesh is None else self.mesh[r, 0, 0]
            rep_schedule = schedule.to(lead)
            built.append(make_paths(ms, rep_schedule, rep_schedule if hschedule is schedule else hschedule.to(lead)))
        if len(built) == 1:
            self._paths, self._turbo_paths, self._fused_path = built[0]
        else:
            self._paths, self._turbo_paths, self._fused_path = (
                {n: self._over_dp([b[0][n] for b in built]) for n in built[0][0]},
                {n: self._over_dp([b[1][n] for b in built]) for n in built[0][1]},
                self._over_dp([b[2] for b in built]) if cfg.fused_request else None,
            )

        s = cfg.img_size
        dp = len(replicas)
        buckets = cfg.batch_buckets
        if buckets == "auto":
            buckets = (1, 2, 4, 8) if s <= 256 else (1,)
        # a batch splits over dp: each bucket rounds up to a multiple of dp
        buckets = tuple(sorted({-(-int(b) // dp) * dp for b in buckets}))
        if cfg.aot_dir:
            # every caller below (fns, turbo_fns, the batcher, the warm-up,
            # process_all) serves the pins
            self._pin_executables(buckets if cfg.batching else (1,))
        self.fns = {n: self._bind(self._paths, n) for n in self._paths}
        self.turbo_fns: Optional[Dict[str, Callable]] = (
            {n: self._bind(self._turbo_paths, n) for n in self._turbo_paths} if cfg.adaptive_turbo else None
        )
        self.fused: Optional[Callable[[np.ndarray], Dict[str, np.ndarray]]] = (
            (lambda x: self._on_device_thread(self._run_fused, x)) if cfg.fused_request else None
        )

        if cfg.batching:
            # the batcher warms every bucket of every function
            self.batcher = MicroBatcher(
                self.fns,
                buckets=buckets,
                max_wait_ms=cfg.batch_max_wait_ms,
                warmup_shape=(s, s, 1) if cfg.warmup else None,
                fused_fn=self.fused,
                turbo_fns=self.turbo_fns,
                turbo_queue_depth=cfg.adaptive_queue_depth,
                max_queue_depth=cfg.max_queue_depth,
            )
        elif cfg.warmup:
            xw = np.zeros((dp, s, s, 1), np.float32)
            warm = dict(self.fns)
            if self.fused is not None:
                warm["fused(all4)"] = self.fused
            for name, fn in warm.items():
                t = time.time()
                fn(xw)
                log.latency("warmup_compile", time.time() - t, model=name)

        for n in MODEL_NAMES:
            self.loaded[n] = True

    @staticmethod
    def _pack(state: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
        """The tensors of ``state``, by dtype, in one flat buffer each (in
        name order, each start aligned to 16 elements), and where each lies:
        {name: (dtype key, offset, shape)}. A program takes the few buffers
        as its inputs, not a tensor a weight: AOTInductor writes checks for
        every input of a program, and at a thousand inputs their code made
        most of the compile."""
        layout, sizes = {}, collections.Counter()
        for name in sorted(state):
            t = state[name]
            key = str(t.dtype).replace("torch.", "")
            layout[name] = (key, sizes[key], tuple(t.shape))
            sizes[key] += -(-t.numel() // 16) * 16
        some = next(iter(state.values()))
        flats = {key: torch.zeros(n, dtype=getattr(torch, key), device=some.device) for key, n in sizes.items()}
        for name, (key, off, shape) in layout.items():
            flats[key][off:off + state[name].numel()].copy_(state[name].reshape(-1))
        return flats, layout

    @staticmethod
    def _tree_ident(layout: Dict[str, tuple]) -> str:
        """Structural identity of a packed state (names, dtypes, offsets,
        shapes). The weights are program inputs, so a pin serves any values
        of the same structure; a change of architecture changes this."""
        return hashlib.sha256(repr(sorted(layout.items())).encode()).hexdigest()[:16]

    def _pin_state(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple], nn.ModuleDict]:
        """(flats, layout, models): the replica's models as one
        ``ModuleDict`` (each model once, so weights two paths share stay
        shared) and their parameters and buffers (int8 scales included),
        packed by ``_pack``."""
        models = nn.ModuleDict({k: m for k, m in self.replicas[0].items() if m is not None})
        flats, layout = self._pack(
            {k: t.detach() for k, t in (*models.named_parameters(), *models.named_buffers())})
        return flats, layout, models

    def _pinned(self, name: str, batch: int) -> Tuple[nn.Module, tuple]:
        """The module that the pin of path ``name`` (``turbo@<path>`` for a
        turbo path) at ``batch`` exports, and its example inputs ``(flats,
        x)``: the path, its models (``PATH_MODELS``) reparametrised by views
        of the whole replica's ``flats``."""
        flats, layout, models = self._pin_state()
        path = name.split("@")[-1]
        table = self._turbo_paths if name.startswith("turbo@") else self._paths
        used = nn.ModuleDict({k: m for k in PATH_MODELS[path] if (m := self.replicas[0][k]) is not None})
        ids = {id(m) for m in used.modules()}
        others = nn.ModuleDict({k: m for k, m in models.items() if id(m) not in ids})
        where = {id(t): layout[n] for n, t in (*models.named_parameters(), *models.named_buffers())}
        own = {n: where[id(t)] for n, t in (*used.named_parameters(), *used.named_buffers())}
        s = self.cfg.img_size
        x = torch.zeros((batch, 1, s, s), dtype=torch.float32, device=self.device)
        return _Pinned(table[path], used, own, others), (flats, x)

    def _pin_jobs(self, batches: Tuple[int, ...], aot_dir: str) -> list:
        """The pins of every serving program (each path, and each turbo
        path under ``adaptive_turbo``, at each of ``batches``; the fused
        function is not pinned) as ``pin_all``'s jobs, and the packed state
        they take: (flats, [(name, batch, (pin path under ``aot_dir``,
        (flats, x), build))]), ``build`` a ``pin_module`` of this engine's
        config. They come in the order a
        cold start compiles them, the longest first (a compile is Python on
        one core: the hybrid rollouts, the diffusion ones, then the one-forward
        paths; larger batches first), so that the queued ones fill the cores
        the long ones leave."""
        cfg = self.cfg
        s = cfg.img_size
        flats, layout, _ = self._pin_state()
        ident = dict(
            img_size=s, device=str(self.device),
            steps=(cfg.diffusion_steps, cfg.hybrid_diffusion_steps),
            eps=(self.diffusion_eps_reuse, self.hybrid_eps_reuse,
                 cfg.adaptive_diffusion_eps if cfg.adaptive_turbo else None,
                 cfg.adaptive_hybrid_eps if cfg.adaptive_turbo else None),
            dtype=(str(cfg.compute_dtype), bool(cfg.diffusion_eval_bf16), bool(cfg.hybrid_rollout_bf16)),
            quant=str(cfg.quantize_int8), flash=bool(cfg.use_flash_attention), s2d=bool(cfg.nafnet_s2d),
            # beyond the JAX engine's key: program constants the weights'
            # shapes do not show
            schedule_cfg=cfg.schedule_cfg, resolved=self._resolved,
            expert_tree=self.hybrid_expert_tree, weights=self._tree_ident(layout),
        )
        names = [*self._paths, *(f"turbo@{name}" for name in self._turbo_paths)]
        rank = ("hybrid", "diffusion", "turbo@hybrid", "turbo@diffusion", "nafnet", "expert")
        order = sorted(names, key=rank.index)
        x_like = torch.zeros((1, 1, s, s), dtype=torch.float32, device=self.device)
        return flats, [
            (name, b, (os.path.join(aot_dir, f"{name}_b{b}_{aot_fingerprint(model=name, batch=b, **ident)}.pt2"),
                       (flats, x_like.expand(b, -1, -1, -1).contiguous()),
                       functools.partial(pin_module, cfg, name, b)))
            for name in order for b in sorted(map(int, batches), reverse=True)]

    def _pin_executables(self, batches: Tuple[int, ...]) -> None:
        """Pin every serving program (``_pin_jobs``): load it from
        ``cfg.aot_dir`` where a pin with its key is there, else compile it
        there, in a worker process that builds this engine's models and
        path anew (``pin_module``: the weights and int8 scales are inputs,
        so any values serve) and exports them, as many at once as
        ``pin_workers`` allows. Each entry of ``_paths`` / ``_turbo_paths``
        becomes an ``AotDispatch`` that serves the pinned batch sizes and
        sends other sizes to the eager path. ``aot_report`` gets each pin's
        load seconds, or its export and compile seconds."""
        t_all = time.time()
        flats, jobs = self._pin_jobs(batches, self.cfg.aot_dir)
        s = self.cfg.img_size
        x_like = torch.zeros((1, 1, s, s), dtype=torch.float32, device=self.device)
        t = time.time()
        results = pin_all([job for _, _, job in jobs], device=self.device)
        secs = time.time() - t  # one start's pins load, or compile, together
        execs: Dict[str, Dict[int, Any]] = collections.defaultdict(dict)
        for (name, b, _), (program, loaded, info) in zip(jobs, results):
            execs[name][b] = program
            self.aot_report[f"{name}_b{b}"] = {"loaded": loaded, "secs": round(secs, 2),
                                               **{k: round(v, 2) if isinstance(v, float) else v for k, v in info.items()}}
            times = {k: round(info[k], 2) for k in ("load_s", "export_s", "compile_s") if k in info}
            log.latency("aot_load" if loaded else "aot_compile", secs, model=name, batch=b, **times)
        for name in execs:
            table = self._turbo_paths if name.startswith("turbo@") else self._paths
            path = name.split("@")[-1]
            self._aot[name] = AotDispatch(table[path], execs[name], bound_args=(flats,), like=x_like)
            # every caller (fns, turbo_fns, the batcher, the warm-up,
            # process_all) reads the table
            table[path] = self._aot[name]
        log.latency("aot_ready", time.time() - t_all, n=len(self.aot_report))

    @property
    def aot_served(self) -> Dict[str, Dict[int, int]]:
        """Calls each pinned program answered: {name: {batch: calls}}."""
        return {name: dict(d.served) for name, d in self._aot.items()}

    @property
    def aot_dropped(self) -> int:
        """Pinned programs that raised and were dropped for the eager path."""
        return sum(d.dropped for d in self._aot.values())

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

    def _over_dp(self, fns: List[Callable]) -> Callable:
        """A function of a batch that runs equal parts of its rows through
        ``fns``, one per dp replica, each on its replica's thread, and
        concatenates their outputs (tensors, or dicts of them) in row order
        on the engine's device."""
        def fn(x: torch.Tensor):
            dp = len(fns)
            if x.shape[0] % dp:
                raise ValueError(f"a batch of {x.shape[0]} rows does not split over dp={dp} replicas "
                                 f"(under batching the buckets round up to multiples of dp)")
            futures = [pool.submit(self._on_replica, f, part.to(lead))
                       for pool, f, part, lead in zip(self._replicas, fns, x.chunk(dp), self.mesh[:, 0, 0])]
            wait(futures)
            outs = [f.result() for f in futures]
            if isinstance(outs[0], dict):
                return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}
            return torch.cat([o.to(self.device) for o in outs])

        return fn

    @staticmethod
    def _on_replica(fn: Callable, x: torch.Tensor):
        with torch.inference_mode():
            return fn(x)

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
        """The four paths on the device thread, each one's wall kept in
        ``path_ms``; a path that raises gives None."""
        outs: Dict[str, Optional[np.ndarray]] = {}
        with torch.inference_mode():
            xt = self._to_device(x)
            for name in MODEL_NAMES:
                try:
                    t0 = time.time()
                    outs[name] = self._to_host(self._paths[name](xt))
                    self.path_ms[name].append((time.time() - t0) * 1e3)
                except Exception as e:  # noqa: BLE001  per-path isolation
                    log.log("model_failed", model=name, error=str(e))
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
                log.log("fused_dispatch_failed", error=str(e))
        return self._on_device_thread(self._run_all, x), "per_path"

    def process_one(self, name: str, x: np.ndarray, original_size) -> Optional[str]:
        """Run one model path; returns base64 PNG or raises. Logs the JAX
        engine's ``request`` event (``midd_tpu/serve/engine.py:1148-1154``)."""
        t0 = time.time()
        out = self.fns[name](x)
        result = tensor_to_base64_png(out, original_size)
        log.latency("request", time.time() - t0, model=name)
        return result

    def process_all(self, x: np.ndarray, original_size) -> Dict[str, Optional[str]]:
        """All four paths with per-path failure isolation (run.py:85-101): a
        path that fails answers None and the others still answer. The PNG
        encode runs on the calling thread, beside the next request's or
        batch's device work. The log events are the JAX engine's: ``encode``
        for each path encoded (fused or per path; a batched request logs
        none), then ``request_all``."""
        t_start = time.time()
        outs, mode = self._outputs(x)
        results: Dict[str, Optional[str]] = {}
        for name in MODEL_NAMES:
            out = outs.get(name)
            if out is None:
                results[name] = None
                continue
            try:
                t0 = time.time()
                results[name] = tensor_to_base64_png(out, original_size)
                if mode != "batched":
                    log.latency("encode", time.time() - t0, model=name)
            except Exception as e:  # noqa: BLE001  per-path isolation
                log.log("model_failed", model=name, error=str(e))
                results[name] = None
        log.latency("request_all", time.time() - t_start, mode="per_path" if mode == "fused" else mode)
        return results

    def close(self) -> None:
        """Stop the batcher, then the device thread and the dp replicas'."""
        if self.batcher is not None:
            self.batcher.stop()
        self._device.shutdown(wait=True)
        for pool in self._replicas:
            pool.shutdown(wait=True)

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
            # the layouts computed: the plain ones, whatever nafnet_s2d says
            # (the JAX engine reports its space-to-depth restructurings here)
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
            # with batching, the batcher's counts (requests, batches, turbo
            # batches, rejections); pinned, the calls each program answered
            # by batch size and the programs dropped for the eager path
            **({"batching": self.batcher.stats} if self.batcher is not None else {}),
            **({"aot": {"served": self.aot_served, "dropped": self.aot_dropped}} if self._aot else {}),
        }


class _PinEngine(InferenceEngine):
    """The engine a compile worker builds (``pin_module``). Static int8 does
    not calibrate here: the scales are buffers, which ride in the packed
    state as program inputs, so the worker's values never reach a program.
    Each int8 convolution takes a placeholder of the calibrated scale's
    shape (a scalar NaN: a program that read it would answer NaN), and
    ``int8_scales`` and ``calibration_ms`` stay empty."""

    def _calibrate(self, name: str, unet: nn.Module, schedule: Schedule, steps: int) -> None:
        load_qscales(unet, {n: torch.tensor(float("nan")) for n, mod in unet.named_modules()
                            if isinstance(mod, QuantConv2d)})
