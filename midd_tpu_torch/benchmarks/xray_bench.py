"""The xraybench-v1 quality benchmark of the port (counterpart of
``midd_tpu/benchmarks/xray_bench.py``; the port imports nothing of
``midd_tpu``, so this is its own copy of the protocol).

A fixed, versioned eval set of procedural X-ray-like phantoms corrupted by
the three noise families of the reference (speckle, quantum-Poisson,
Gaussian), scored with the skimage-exact PSNR/SSIM of ``train/metrics.py``.
Phantom geometry, the per-image noise draws (numpy, crc32-seeded) and the
train/eval split are those of the JAX package bit for bit, so both packages
score the identical set; changing any of it bumps ``PROTOCOL_VERSION``.

It trains the four served models at serve (or tiny) width on the protocol's
train split with the JAX package's recipes and numbers, scores every served
path through the port's engine, the variants (``diffusion_w96``,
``expert_ftl2(branch)``, ``diffusion_ddim50@50``), a seed-variance study and
the turbo gate, and prints the same table and JSON payload as the JAX CLI.

Checkpoints are the port's ``<ckpt_dir>/<name>.pth``. A training run that
finished writes ``<name>.done`` beside it (JSON: the protocol and the
phases it finished; the NAFNet's are "reference" and "l2"), and the seed
study reuses only runs so marked. Two faults of the JAX module are not
copied: it reuses any seed run whose directory exists, an interrupted one
too, and its ``score_variant`` leaks its view directory and drops a seed
that cannot be scored without a word. Here every link source is checked
before a seed trains, a missing one raises with its name, and the view
directory is made after that check and removed in a ``finally``. An orbax
directory (the JAX package's checkpoints) raises with the converter's
command (``orbax_bridge.py``).

Usage:
    # train all four models on the protocol's train split, then score
    python -m midd_tpu_torch.benchmarks.xray_bench --train --ckpt-dir bench_ckpts

    # score existing checkpoints (or demo weights) on the eval set
    python -m midd_tpu_torch.benchmarks.xray_bench --ckpt-dir bench_ckpts

    # quality/speed frontier of the turbo (eps_reuse) paths against ground truth
    python -m midd_tpu_torch.benchmarks.xray_bench --turbo-gate --ckpt-dir bench_ckpts

    # on the CPU at smoke scale
    python -m midd_tpu_torch.benchmarks.xray_bench --train --device cpu \\
        --width-preset tiny --img-size 64 --n-train 8 --n-eval 1 --epochs-scale 0.01
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PROTOCOL_VERSION = "xraybench-v1"
EVAL_SEED = 20260816
TRAIN_SEED = 7041776  # disjoint from the eval stream by construction
NOISE_TYPES = ("gaussian", "speckle", "poisson")

# the phases a finished run of each seed-study model has recorded
SEED_PHASES = {"diffusion": ("diffusion",), "nafnet": ("reference", "l2"), "hybrid": ("hybrid",)}
# the checkpoints a hybrid is scored beside (engine name -> source name)
HYBRID_BACKENDS = {"nafnet": "nafnet", "diffusion": "diffusion", "expert": "expert",
                   "expert_ftl2": "expert_ftl2"}


# ---------------------------------------------------------------------------
# Phantoms: procedural chest-X-ray-like images
# ---------------------------------------------------------------------------


def make_phantoms(n: int, size: int, seed: int) -> np.ndarray:
    """Structured synthetic radiographs: torso with soft-tissue gradient,
    darker lung fields, spine column, periodic ribs, and bright nodules —
    enough anatomical structure that edge/SSIM terms and the denoisers'
    frequency behavior are exercised like on real X-rays. Deterministic in
    (n, size, seed). Returns (N, H, W, 1) float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = []
    for _ in range(n):
        # background illumination + soft tissue
        img = 0.18 + 0.22 * (
            xx * rng.uniform(0.4, 1.4) + yy * rng.uniform(0.3, 1.1)
        ) / 2.0
        # torso: bright wide ellipse
        cx, cy = rng.uniform(0.45, 0.55), rng.uniform(0.45, 0.55)
        d = ((xx - cx) / rng.uniform(0.32, 0.42)) ** 2 + (
            (yy - cy) / rng.uniform(0.42, 0.5)
        ) ** 2
        img = img + 0.35 * np.exp(-d * 1.6)
        # lung fields: two darker ellipses inside the torso
        for sx in (-1.0, 1.0):
            lx = cx + sx * rng.uniform(0.13, 0.19)
            ly = cy - rng.uniform(0.02, 0.08)
            dl = ((xx - lx) / rng.uniform(0.1, 0.14)) ** 2 + (
                (yy - ly) / rng.uniform(0.18, 0.26)
            ) ** 2
            img = img - rng.uniform(0.12, 0.2) * np.exp(-dl * 2.2)
        # spine: bright vertical column
        img = img + rng.uniform(0.08, 0.14) * np.exp(
            -(((xx - cx) / rng.uniform(0.025, 0.04)) ** 2)
        )
        # ribs: periodic bands inside the torso envelope
        freq = rng.uniform(7, 13)
        phase = rng.uniform(0, np.pi)
        img = img + 0.05 * np.maximum(
            0, np.sin(yy * np.pi * freq + phase)
        ) * np.exp(-d * 1.6)
        # nodules / calcifications: small bright blobs
        for _ in range(rng.integers(1, 4)):
            bx, by = rng.uniform(0.25, 0.75, 2)
            br = rng.uniform(0.01, 0.04)
            db = ((xx - bx) ** 2 + (yy - by) ** 2) / br**2
            img = img + rng.uniform(0.1, 0.25) * np.exp(-db)
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs)[..., None].astype(np.float32)


# ---------------------------------------------------------------------------
# The fixed eval set and the train split
# ---------------------------------------------------------------------------


def make_eval_set(
    n_per_noise: int = 8,
    img_size: int = 256,
    noise_types: Sequence[str] = NOISE_TYPES,
) -> List[Tuple[np.ndarray, np.ndarray, str]]:
    """The versioned eval set: ``n_per_noise`` phantoms per noise family with
    FIXED per-image noise draws. Returns [(clean, noisy, noise_type)]."""
    from midd_tpu_torch.train.data import NOISE_FNS

    items = []
    clean_all = make_phantoms(n_per_noise * len(noise_types), img_size, EVAL_SEED)
    idx = 0
    for nt in noise_types:
        fn = NOISE_FNS[nt]
        for _ in range(n_per_noise):
            clean = clean_all[idx]
            # crc32, NOT hash(): python's str hash is salted per process
            noise_rng = np.random.default_rng(
                (EVAL_SEED * 1_000_003 + idx * 97 + zlib.crc32(nt.encode())) % (2**63)
            )
            noisy = np.clip(fn(clean, noise_rng), 0.0, 1.0).astype(np.float32)
            items.append((clean, noisy, nt))
            idx += 1
    return items


def make_train_dataset(
    n: int = 96,
    img_size: int = 256,
    noise_type: str = "mixed",
    seed: int = TRAIN_SEED,
    noise_seed: Optional[int] = None,
):
    """Training split: fresh phantoms (disjoint seed stream from eval) with
    on-the-fly noise. ``noise_type='mixed'`` rotates the three families by
    index. ``noise_seed`` seeds the noise and augmentation draws only, and
    leaves the phantom geometry protocol-fixed (what the seed study varies).
    The draws are consumed in order (a training epoch's order), as in the
    JAX package, so a model's draws depend on what trained before it off
    the same dataset object."""
    from midd_tpu_torch.train.data import NOISE_FNS, SyntheticPairedDataset, augment_pair

    clean = make_phantoms(n, img_size, seed)
    nseed = seed if noise_seed is None else noise_seed
    if noise_type != "mixed":
        return SyntheticPairedDataset(clean, noise_type=noise_type, seed=nseed)

    class _Mixed(SyntheticPairedDataset):
        # the family comes from the index, not from a shared attribute, so
        # that the trainer's loader threads cannot race on it
        def item(self, idx, rng):
            clean = self.clean[idx]
            noisy = NOISE_FNS[NOISE_TYPES[idx % len(NOISE_TYPES)]](clean, rng)
            if self.is_train:
                clean, noisy = augment_pair(clean, noisy, self.augment, rng)
            return clean, noisy

    return _Mixed(clean, noise_type=NOISE_TYPES[0], seed=nseed)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


def score_fn(fn: Callable, eval_set, batch: int = 4) -> Dict[str, Dict[str, float]]:
    """Score ``fn(noisy_batch) -> pred_batch`` ((B, H, W, 1) numpy in, an
    array or a tensor of that shape out) against ground truth on the eval
    set. Returns {noise_type: {psnr, ssim, n}, "overall": {...}}."""
    from midd_tpu_torch.train.metrics import compute_metrics

    by_type: Dict[str, List[Tuple[float, float]]] = {}
    for i in range(0, len(eval_set), batch):
        chunk = eval_set[i : i + batch]
        noisy = np.stack([c[1] for c in chunk])
        clean = np.stack([c[0] for c in chunk])
        pred = fn(noisy)
        if torch.is_tensor(pred):
            pred = pred.detach().float().cpu().numpy()
        pred = np.asarray(pred)
        for j, (_, _, nt) in enumerate(chunk):
            p, s = compute_metrics(torch.from_numpy(pred[j, ..., 0]), torch.from_numpy(clean[j, ..., 0]))
            # an EXACT reconstruction yields PSNR=inf: keep the image (its
            # SSIM=1 counts; the PSNR mean is over finite values only)
            # rather than dropping it and penalising the better model
            if np.isfinite(float(s)):
                by_type.setdefault(nt, []).append((float(p), float(s)))

    def _summ(vals):
        fin = [v[0] for v in vals if np.isfinite(v[0])]
        return {
            # every image exactly reconstructed -> no finite PSNR: None
            # (strict JSON; json.dump would write the token Infinity)
            "psnr": float(np.mean(fin)) if fin else None,
            "ssim": float(np.mean([v[1] for v in vals])),
            "n": len(vals),
        }

    out: Dict[str, Dict[str, float]] = {}
    allv: List[Tuple[float, float]] = []
    for nt, vals in by_type.items():
        allv.extend(vals)
        out[nt] = _summ(vals)
    out["overall"] = _summ(allv)
    return out


def score_engine(
    engine,
    eval_set,
    models: Sequence[str] = ("diffusion", "nafnet", "expert", "hybrid"),
    timer=None,
) -> Dict[str, Dict]:
    """Score engine paths + the identity (noisy input) baseline, first.
    ``timer`` (a ``utils.profiling.Timer``): one section per row."""
    results = {}
    for name, fn in [("_input", lambda x: x)] + [(n, engine.fns[n]) for n in models]:
        with timer.section(name) if timer is not None else contextlib.nullcontext():
            results[name] = score_fn(fn, eval_set)
    return results


def format_table(results: Dict[str, Dict], noise_types=NOISE_TYPES) -> str:
    hdr = f"{'model':<10}" + "".join(
        f"{nt + ' PSNR/SSIM':>22}" for nt in noise_types
    ) + f"{'overall':>22}"
    lines = [hdr, "-" * len(hdr)]
    for name, r in results.items():
        row = f"{name:<10}"
        for nt in list(noise_types) + ["overall"]:
            if nt in r:
                p = r[nt]["psnr"]
                ps = "exact" if p is None else f"{p:.2f}"
                row += f"{ps:>13}/{r[nt]['ssim']:.4f}"
            else:
                row += f"{'-':>22}"
        lines.append(row)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Checkpoints: the port's .pth files and their completion markers
# ---------------------------------------------------------------------------


def _marker(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, f"{name}.done")


def has_checkpoint(ckpt_dir: str, name: str) -> bool:
    """Whether ``<ckpt_dir>/<name>.pth`` exists; an orbax directory of that
    name raises with the converter's command."""
    from midd_tpu_torch.utils.checkpoint import orbax_message

    path = os.path.join(ckpt_dir, name)
    if os.path.isdir(path):
        raise NotImplementedError(orbax_message(path))
    return os.path.exists(path + ".pth")


def completed_phases(ckpt_dir: str, name: str) -> Optional[Tuple[str, ...]]:
    """The phases ``<name>.done`` records, or None where there is no marker
    or no ``.pth`` beside it."""
    if not (has_checkpoint(ckpt_dir, name) and os.path.exists(_marker(ckpt_dir, name))):
        return None
    with open(_marker(ckpt_dir, name)) as f:
        return tuple(json.load(f)["phases"])


def _start_run(ckpt_dir: str, name: str) -> None:
    """A run of ``name`` begins: until it marks a phase it is unfinished."""
    with contextlib.suppress(FileNotFoundError):
        os.remove(_marker(ckpt_dir, name))


def mark_phase(ckpt_dir: str, name: str, phases: Sequence[str]) -> None:
    """Record that the run of ``name`` finished ``phases`` (its ``.pth`` holds
    their result); written atomically."""
    if not has_checkpoint(ckpt_dir, name):
        raise FileNotFoundError(f"{name}: training finished but wrote no {name}.pth in {ckpt_dir}")
    tmp = _marker(ckpt_dir, name) + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"protocol": PROTOCOL_VERSION, "phases": list(phases)}, f)
    os.replace(tmp, _marker(ckpt_dir, name))


def _require_sources(ckpt_dir: str, links: Dict[str, str]) -> Dict[str, str]:
    """``links`` (engine name -> source name under ``ckpt_dir``) -> engine
    name -> the source's absolute ``.pth`` path. Raises before anything is
    made: FileNotFoundError naming every missing source, or the orbax
    message for a source that is an orbax directory."""
    missing = [src for src in links.values() if not has_checkpoint(ckpt_dir, src)]
    if missing:
        raise FileNotFoundError(f"missing checkpoint(s) in {ckpt_dir}: "
                                + ", ".join(f"{m}.pth" for m in missing))
    return {dst: os.path.abspath(os.path.join(ckpt_dir, src)) + ".pth" for dst, src in links.items()}


# ---------------------------------------------------------------------------
# Training on the protocol
# ---------------------------------------------------------------------------


# The protocol's recipes (the reference's numbers, as the JAX benchmark's):
# TrainConfig fields before the epoch scale
RECIPES = {
    "nafnet": dict(epochs=50, batch_size=2, lr=2e-4, weight_decay=1e-4, warmup_epochs=5),
    "nafnet_l2": dict(epochs=20, batch_size=2, lr=5e-5, weight_decay=1e-4, warmup_epochs=0,
                      eta_min_factor=0.02),
    "diffusion": dict(epochs=30, batch_size=2, lr=2e-4, weight_decay=1e-4),
    "expert": dict(epochs=70, batch_size=4, lr=1e-4, weight_decay=1e-5, warmup_epochs=5),
    "expert_l2": dict(epochs=25, batch_size=4, lr=3e-5, weight_decay=1e-5, warmup_epochs=0,
                      eta_min_factor=0.02),
    "hybrid": dict(epochs=50, batch_size=4, lr=4e-4, weight_decay=1e-4, eta_min_factor=0.02,
                   patience=20),
}


def recipe(name: str, epochs_scale: float, ckpt_dir: str, ckpt_name: str, **kw):
    """The ``TrainConfig`` of recipe ``name`` writing ``<ckpt_dir>/<ckpt_name>.pth``,
    its epochs scaled by ``epochs_scale`` (at least 2); ``kw`` adds fields
    (``seed``)."""
    from midd_tpu_torch.train.trainer import TrainConfig

    cfg = dict(RECIPES[name], ckpt_name=ckpt_name, ckpt_dir=ckpt_dir, **kw)
    cfg["epochs"] = max(2, int(cfg["epochs"] * epochs_scale))
    return TrainConfig(**cfg)


def _tiny_configs(hybrid_profile: str):
    """The tiny preset (the training CLI's ``--preset tiny`` widths); the
    hybrid's fusion follows the profile, its rollouts are the default 10."""
    from midd_tpu_torch import config
    from midd_tpu_torch.train.recipes import TINY_EXPERT, TINY_HYBRID, TINY_NAFNET, TINY_UNET

    diff_cfg = config.DiffusionUNetConfig(**TINY_UNET)
    tpu = hybrid_profile == "tpu"
    hyb_cfg = config.HybridConfig(
        nafnet=TINY_NAFNET, diffusion=diff_cfg, expert=TINY_EXPERT, router=TINY_HYBRID.router,
        fusion=dataclasses.replace(TINY_HYBRID.fusion, residual=tpu, sees_expert=tpu),
    )
    return TINY_NAFNET, diff_cfg, TINY_EXPERT, hyb_cfg


def train_all(
    ckpt_dir: str,
    img_size: int = 256,
    n_train: int = 96,
    epochs_scale: float = 1.0,
    width_preset: str = "serve",
    hybrid_profile: str = "reference",
    device: str = "cuda",
):
    """Train nafnet -> diffusion -> expert -> hybrid on the protocol's train
    split with the reference recipes (epochs scaled by ``epochs_scale``, at
    least 2), each marked done when it finishes.

    ``hybrid_profile``: "reference" reproduces the reference architecture and
    loss (the v1 protocol default); "tpu" trains the JAX package's adopted
    flagship (``config.TPU_HYBRID``'s residual expert-fed fusion with
    ``loss_variant="l2"``) and gives the NAFNet a low-lr pure-MSE polish
    after its reference-loss phase (saved over ``nafnet``), and the expert
    one into its own tree, ``expert_ftl2``, which feeds the hybrid's expert
    branch while the standalone expert keeps the reference-loss weights."""
    from midd_tpu_torch import config
    from midd_tpu_torch.train import recipes

    if hybrid_profile not in ("reference", "tpu"):
        raise ValueError(f"hybrid_profile must be 'reference' or 'tpu', got {hybrid_profile!r}")
    ds = make_train_dataset(n_train, img_size)
    r = lambda name, ckpt_name: recipe(name, epochs_scale, ckpt_dir, ckpt_name)  # noqa: E731

    tpu_fusion = config.FusionConfig(residual=True, sees_expert=True)
    if width_preset == "serve":
        naf_cfg, diff_cfg, exp_cfg = config.SERVE_NAFNET, config.SERVE_DIFFUSION, config.SERVE_EXPERT
        # backends must match the checkpoints train_hybrid loads
        hyb_cfg = config.HybridConfig(
            nafnet=naf_cfg, diffusion=diff_cfg, expert=exp_cfg,
            fusion=tpu_fusion if hybrid_profile == "tpu" else config.FusionConfig(),
        )
    else:  # "tiny": CI / smoke scale
        naf_cfg, diff_cfg, exp_cfg, hyb_cfg = _tiny_configs(hybrid_profile)
    at = lambda n: os.path.join(ckpt_dir, n)  # noqa: E731

    _start_run(ckpt_dir, "nafnet")
    recipes.train_nafnet(
        ds, naf_cfg, r("nafnet", "nafnet"), device=device,
    )
    mark_phase(ckpt_dir, "nafnet", ["reference"])
    if hybrid_profile == "tpu":
        # the l2 polish: parameters from the reference-loss checkpoint,
        # fresh low-lr cosine, pure MSE, saved over the served name
        recipes.train_nafnet(
            ds, naf_cfg, r("nafnet_l2", "nafnet"),
            loss_variant="l2", init_from=at("nafnet"), device=device,
        )
        mark_phase(ckpt_dir, "nafnet", ["reference", "l2"])
    _start_run(ckpt_dir, "diffusion")
    recipes.train_diffusion(
        ds, diff_cfg, train_cfg=r("diffusion", "diffusion"), device=device,
    )
    mark_phase(ckpt_dir, "diffusion", ["diffusion"])
    _start_run(ckpt_dir, "expert")
    recipes.train_expert(
        ds, exp_cfg, r("expert", "expert"), device=device,
    )
    mark_phase(ckpt_dir, "expert", ["reference"])
    if hybrid_profile == "tpu":
        # the expert's l2 polish lands in a second tree (the hybrid's branch)
        _start_run(ckpt_dir, "expert_ftl2")
        recipes.train_expert(
            ds, exp_cfg, r("expert_l2", "expert_ftl2"),
            loss_variant="l2", init_from=at("expert"), device=device,
        )
        mark_phase(ckpt_dir, "expert_ftl2", ["l2"])
    _start_run(ckpt_dir, "hybrid")
    recipes.train_hybrid(
        ds,
        nafnet_ckpt=at("nafnet"),
        diffusion_ckpt=at("diffusion"),
        expert_ckpt=at("expert_ftl2") if hybrid_profile == "tpu" else None,
        hybrid_cfg=hyb_cfg,
        train_cfg=r("hybrid", "hybrid"),
        loss_variant="l2" if hybrid_profile == "tpu" else "reference",
        device=device,
    )
    mark_phase(ckpt_dir, "hybrid", ["hybrid"])


def train_wide_standalone(ckpt_dir: str, img_size: int = 256, n_train: int = 96,
                          epochs_scale: float = 1.0, device: str = "cuda"):
    """Train the wide (96-channel) standalone diffusion under the protocol
    recipe into ``<ckpt_dir>/diffusion_w96.pth``; the scorer adds a
    ``diffusion_w96`` row when it exists (the engine reads the width from
    the checkpoint's metadata)."""
    from midd_tpu_torch import config
    from midd_tpu_torch.train import recipes

    ds = make_train_dataset(n_train, img_size)
    _start_run(ckpt_dir, "diffusion_w96")
    recipes.train_diffusion(
        ds, config.WIDE_DIFFUSION,
        train_cfg=recipe("diffusion", epochs_scale, ckpt_dir, "diffusion_w96"),
        device=device,
    )
    mark_phase(ckpt_dir, "diffusion_w96", ["diffusion"])


def train_ddim50_faithful(ckpt_dir: str, img_size: int = 256, n_train: int = 96,
                          epochs_scale: float = 1.0, device: str = "cuda"):
    """Train a w48 diffusion whose best-checkpoint selection rolls out the
    full 50 steps at each validation (the reference validates at 15,
    serving uses 8), into ``<ckpt_dir>/diffusion_ddim50.pth``; scored at 50
    steps as the ``diffusion_ddim50@50`` row."""
    from midd_tpu_torch import config
    from midd_tpu_torch.train import recipes

    ds = make_train_dataset(n_train, img_size)
    _start_run(ckpt_dir, "diffusion_ddim50")
    recipes.train_diffusion(
        ds, config.SERVE_DIFFUSION,
        train_cfg=recipe("diffusion", epochs_scale, ckpt_dir, "diffusion_ddim50"),
        val_inference_steps=50,
        device=device,
    )
    mark_phase(ckpt_dir, "diffusion_ddim50", ["diffusion"])


# ---------------------------------------------------------------------------
# Variants, the seed study and the turbo gate
# ---------------------------------------------------------------------------


def score_variant(ckpt_dir: str, links: Dict[str, str], path_name: str,
                  eval_set, base_kw: dict):
    """Score one engine path on a view checkpoint directory of symlinks:
    ``links`` maps engine checkpoint names to source names under
    ``ckpt_dir`` (``<dst>.pth`` -> ``<src>.pth``; the arch comes from the
    checkpoints' metadata, so variant widths serve drop-in). Every source is
    checked first (a missing one raises, naming it, before the view exists);
    the view is removed whether scoring succeeds or fails."""
    from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    sources = _require_sources(ckpt_dir, links)
    view = tempfile.mkdtemp(prefix=f"xb_{path_name}_")
    try:
        for dst, src in sources.items():
            os.symlink(src, os.path.join(view, f"{dst}.pth"))
        kw = dict(base_kw)
        kw.update(ckpt_dir=view, warmup=False)
        eng = InferenceEngine(EngineConfig(**kw))
        try:
            return score_fn(eng.fns[path_name], eval_set)
        finally:
            eng.close()
    finally:
        shutil.rmtree(view, ignore_errors=True)


def score_diffusion_variant(ckpt_dir: str, name: str, eval_set,
                            steps: int, base_kw: dict):
    """Score ``<ckpt_dir>/<name>.pth`` through the real engine as the
    'diffusion' path at ``steps`` steps."""
    kw = dict(base_kw)
    kw["diffusion_steps"] = steps
    return score_variant(ckpt_dir, {"diffusion": name}, "diffusion", eval_set, kw)


def _train_seed(model: str, name: str, sdir: str, ckpt_dir: str, ds, epochs_scale: float,
                seed: int, device: str):
    """One seed run of ``model`` into ``<sdir>/<name>.pth``, each phase
    marked when it finishes."""
    from midd_tpu_torch import config
    from midd_tpu_torch.train import recipes

    r = lambda name_: recipe(name_, epochs_scale, sdir, name, seed=seed)  # noqa: E731
    _start_run(sdir, name)
    if model == "diffusion":
        recipes.train_diffusion(
            ds, config.SERVE_DIFFUSION, train_cfg=r("diffusion"), device=device,
        )
        mark_phase(sdir, name, ["diffusion"])
    elif model == "nafnet":
        # the shipped NAFNet recipe: reference phase + l2 polish
        recipes.train_nafnet(
            ds, config.SERVE_NAFNET, r("nafnet"), device=device,
        )
        mark_phase(sdir, name, ["reference"])
        recipes.train_nafnet(
            ds, config.SERVE_NAFNET, r("nafnet_l2"),
            loss_variant="l2", init_from=os.path.join(sdir, name), device=device,
        )
        mark_phase(sdir, name, ["reference", "l2"])
    else:  # hybrid: against the shipped backends, only router and fusion vary
        recipes.train_hybrid(
            ds,
            nafnet_ckpt=os.path.join(ckpt_dir, "nafnet"),
            diffusion_ckpt=os.path.join(ckpt_dir, "diffusion"),
            expert_ckpt=os.path.join(ckpt_dir, "expert_ftl2"),
            hybrid_cfg=config.HybridConfig(fusion=config.FusionConfig(residual=True, sees_expert=True)),
            train_cfg=r("hybrid"),
            loss_variant="l2",
            device=device,
        )
        mark_phase(sdir, name, ["hybrid"])


def seed_study(ckpt_dir: str, models: Sequence[str], n_seeds: int,
               eval_set, img_size: int = 256, n_train: int = 96,
               epochs_scale: float = 1.0, base_kw: Optional[dict] = None,
               train: bool = True) -> Dict:
    """Protocol seed-variance treatment: retrain each of ``models`` (of
    ``SEED_PHASES``) ``n_seeds`` times with varied seeds (init, shuffle and
    loss draws through ``TrainConfig.seed``, the noise stream through the
    dataset's seed; phantom geometry and eval set fixed) and report per-row
    mean/std/min/max beside the shipped checkpoint's score (seed 0).

    Seed runs land in ``<ckpt_dir>/seed_study/<model>_s<i>.pth`` and are
    scored through the real engine on view directories. A run is reused only
    when its ``.done`` marker records every phase of its recipe; an unmarked
    or unfinished one is retrained (said on stderr), or raises when
    ``train`` is False. Every checkpoint a seed is scored beside is checked
    before it trains: a missing one raises with its name. Hybrid seed runs
    train against the shipped backends (only router and fusion vary)."""
    sdir = os.path.join(ckpt_dir, "seed_study")
    base_kw = dict(base_kw or {})
    base_kw.setdefault("turbo_eps_reuse", 1)
    base_kw.setdefault("hybrid_turbo_eps_reuse", 1)
    device = base_kw.get("device", "cuda")

    out: Dict[str, Dict] = {}
    for model in models:
        if model not in SEED_PHASES:
            raise ValueError(f"seed_study: unknown model {model!r}")
        backends = HYBRID_BACKENDS if model == "hybrid" else {}
        links0 = {model: model, **backends}
        _require_sources(ckpt_dir, links0)  # the shipped run and what it is scored beside
        rows = []
        for i in range(1, n_seeds + 1):
            name = f"{model}_s{i}"
            links = {**links0, model: os.path.join("seed_study", name)}
            done = completed_phases(sdir, name)
            if done == SEED_PHASES[model]:
                print(f"[seed_study] {name}: reusing the finished run ({', '.join(done)})",
                      file=sys.stderr, flush=True)
            elif not train:
                raise RuntimeError(f"seed_study: {name} is not a finished run (phases {done}) "
                                   f"and train=False")
            else:
                if done is not None or has_checkpoint(sdir, name):
                    print(f"[seed_study] {name}: retraining a run that is not marked finished "
                          f"(phases {done})", file=sys.stderr, flush=True)
                # phantom geometry stays protocol-fixed (TRAIN_SEED); the seed
                # varies the noise stream and the init/shuffle/loss draws
                ds = make_train_dataset(n_train, img_size, noise_seed=TRAIN_SEED + i * 1009)
                _train_seed(model, name, sdir, ckpt_dir, ds, epochs_scale, i, device)
            r = score_variant(ckpt_dir, links, model, eval_set, base_kw)
            rows.append({"seed": i, **r["overall"]})
            psnr = r["overall"]["psnr"]
            print(f"[seed_study] {name}: " + ("exact" if psnr is None else f"{psnr:.2f} dB"),
                  flush=True)
        # the shipped checkpoint's own score = the seed-0 sample
        r0 = score_variant(ckpt_dir, links0, model, eval_set, base_kw)
        rows.insert(0, {"seed": 0, **r0["overall"]})
        psnrs = [r["psnr"] for r in rows if r["psnr"] is not None]
        ssims = [r["ssim"] for r in rows]
        out[model] = {
            "rows": rows,
            "psnr_mean": float(np.mean(psnrs)) if psnrs else None,
            "psnr_std": float(np.std(psnrs, ddof=1)) if len(psnrs) > 1 else None,
            "psnr_min": float(np.min(psnrs)) if psnrs else None,
            "psnr_max": float(np.max(psnrs)) if psnrs else None,
            "ssim_mean": float(np.mean(ssims)) if ssims else None,
            "n": len(rows),
        }
        if psnrs:
            print(f"[seed_study] {model}: mean {out[model]['psnr_mean']:.2f}"
                  f" ± {out[model]['psnr_std'] or 0:.2f} dB over "
                  f"{len(psnrs)} runs (shipped + {len(psnrs) - 1} reseeds)", flush=True)
    return out


def turbo_gate(engine_cfg_kwargs: dict, eval_set,
               extra_schedules: Sequence = ()) -> Dict[str, Dict]:
    """Quality/speed frontier of the turbo paths against ground truth: the
    uniform eps strides k = 1, 2, 3 and the explicit refresh-index tuples of
    ``extra_schedules``, each on the diffusion and the hybrid path."""
    from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    results = {}
    settings = [(f"k{k}", k) for k in (1, 2, 3)] + [
        ("idx" + "-".join(str(i) for i in s), tuple(s)) for s in extra_schedules
    ]
    for label, setting in settings:
        eng = InferenceEngine(EngineConfig(
            turbo_eps_reuse=setting, hybrid_turbo_eps_reuse=setting, **engine_cfg_kwargs,
        ))
        try:
            results[f"diffusion_{label}"] = score_fn(eng.fns["diffusion"], eval_set)
            results[f"hybrid_{label}"] = score_fn(eng.fns["hybrid"], eval_set)
        finally:
            eng.close()
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """The CLI; returns the payload it printed."""
    import argparse

    from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    from midd_tpu_torch.utils.profiling import Timer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", default="bench_ckpts")
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--n-eval", type=int, default=8, help="images per noise type")
    ap.add_argument("--n-train", type=int, default=96)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--train-wide", action="store_true",
                    help="train the w96 standalone diffusion under the protocol "
                         "(scored as the diffusion_w96 row)")
    ap.add_argument("--train-ddim50", action="store_true",
                    help="train the DDIM-50-faithful w48 diffusion (best-checkpoint "
                         "selection at 50-step validation; scored at 50 steps as the "
                         "diffusion_ddim50 row)")
    ap.add_argument("--turbo-gate", action="store_true")
    ap.add_argument("--seeds", type=int, default=0, metavar="N",
                    help="seed-variance study: retrain each --seed-models model N extra "
                         "times with varied seeds and report mean±std next to the shipped "
                         "checkpoint's score (runs land in <ckpt-dir>/seed_study/)")
    ap.add_argument("--seed-models", default="diffusion", metavar="M1,M2,...",
                    help="models for --seeds (default: diffusion); nafnet and hybrid accepted")
    ap.add_argument("--turbo-idx", action="append", default=[], metavar="I0,I1,...",
                    help="additional explicit refresh schedules to gate (comma-separated "
                         "scan indices; repeatable)")
    ap.add_argument("--epochs-scale", type=float, default=1.0)
    ap.add_argument("--width-preset", choices=("serve", "tiny"), default="serve")
    ap.add_argument("--hybrid-profile", choices=("reference", "tpu"), default="reference",
                    help="hybrid cell for --train: 'reference' (v1 protocol default) or 'tpu' "
                         "(config.TPU_HYBRID + l2 loss, the adopted flagship)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="serve the diffusion UNets with static-calibrated int8 convs")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    timer = Timer("xray_bench_s", device=args.device)
    training = [(args.train, "train", lambda: train_all(
                    args.ckpt_dir, args.img_size, args.n_train, args.epochs_scale,
                    args.width_preset, args.hybrid_profile, device=args.device)),
                (args.train_wide, "train_wide", lambda: train_wide_standalone(
                    args.ckpt_dir, args.img_size, args.n_train, args.epochs_scale, device=args.device)),
                (args.train_ddim50, "train_ddim50", lambda: train_ddim50_faithful(
                    args.ckpt_dir, args.img_size, args.n_train, args.epochs_scale, device=args.device))]
    for wanted, label, run in training:
        if wanted:
            with timer.section(label):
                run()

    eval_set = make_eval_set(args.n_eval, args.img_size)
    kw = dict(
        img_size=args.img_size,
        diffusion_steps=args.steps,
        hybrid_diffusion_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        warmup=False,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        device=args.device,
    )
    if args.width_preset == "tiny":
        # the scoring engine must model what train_all wrote: the NAFNet and
        # diffusion arch come from checkpoint metadata, but the expert,
        # router and fusion widths do not: mirror train_all's tiny configs
        _, _, expert_cfg, hyb_cfg = _tiny_configs("reference")
        kw.update(expert_cfg=expert_cfg, router_cfg=hyb_cfg.router, fusion_cfg=hyb_cfg.fusion)
    if args.int8:
        kw["quantize_int8"] = "static"

    def finish(payload: Dict, table: Optional[str] = None) -> Dict:
        if table is not None:
            print(table)
        print(json.dumps(payload), flush=True)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(payload, f, indent=1)
        timer.emit(device=args.device)
        return payload

    if args.seeds:
        with timer.section("seed_study"):
            results = seed_study(
                args.ckpt_dir, [m for m in args.seed_models.split(",") if m], args.seeds,
                eval_set, img_size=args.img_size, n_train=args.n_train,
                epochs_scale=args.epochs_scale, base_kw=kw,
            )
        return finish({"protocol": PROTOCOL_VERSION, "img_size": args.img_size,
                       "n_eval": args.n_eval * len(NOISE_TYPES), "seed_study": results})
    if args.turbo_gate:
        extra = [tuple(int(i) for i in s.split(",")) for s in args.turbo_idx]
        with timer.section("turbo_gate"):
            results = turbo_gate(kw, eval_set, extra_schedules=extra)
    else:
        # the protocol scores the EXACT rollouts (k = 1: every step fresh);
        # turbo schedules are gated separately (--turbo-gate)
        kw.setdefault("turbo_eps_reuse", 1)
        kw.setdefault("hybrid_turbo_eps_reuse", 1)
        with timer.section("engine"):
            engine = InferenceEngine(EngineConfig(**kw))
        try:
            results = score_engine(engine, eval_set, timer=timer)
        finally:
            engine.close()
        # the wide standalone at the serving step count
        if has_checkpoint(args.ckpt_dir, "diffusion_w96"):
            with timer.section("diffusion_w96"):
                results["diffusion_w96"] = score_diffusion_variant(
                    args.ckpt_dir, "diffusion_w96", eval_set, args.steps, kw)
        # the hybrid's dedicated branch tree, scored standalone
        if has_checkpoint(args.ckpt_dir, "expert_ftl2"):
            with timer.section("expert_ftl2(branch)"):
                results["expert_ftl2(branch)"] = score_variant(
                    args.ckpt_dir, {"expert": "expert_ftl2"}, "expert", eval_set, kw)
        # the DDIM-50-faithful checkpoint at 50 steps, beside the regular one
        if has_checkpoint(args.ckpt_dir, "diffusion_ddim50"):
            with timer.section("diffusion_ddim50@50"):
                results["diffusion_ddim50@50"] = score_diffusion_variant(
                    args.ckpt_dir, "diffusion_ddim50", eval_set, 50, kw)
            if has_checkpoint(args.ckpt_dir, "diffusion"):
                with timer.section("diffusion@50"):
                    results["diffusion@50"] = score_diffusion_variant(
                        args.ckpt_dir, "diffusion", eval_set, 50, kw)

    return finish({"protocol": PROTOCOL_VERSION, "img_size": args.img_size,
                   "n_eval": args.n_eval * len(NOISE_TYPES), "results": results},
                  format_table(results))


if __name__ == "__main__":
    main()
