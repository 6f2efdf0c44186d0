"""Checkpoint bridge between the JAX package (orbax directories) and its
PyTorch port (``.pth`` files).

The port imports no jax, so it cannot read orbax; this host-side CLI, which
imports both packages, converts in either direction. Run it on a host with
jax and orbax installed (the CPU is enough; it never uses an accelerator):

    # one orbax checkpoint directory (``tree/`` + ``metadata.json``) -> a port .pth
    python orbax_bridge.py to-pth bench_ckpts/nafnet bench_ckpts_torch/nafnet.pth

    # a port (or reference) .pth -> an orbax checkpoint directory
    python orbax_bridge.py to-orbax checkpoints/hybrid.pth ckpts/hybrid --model hybrid

    # every orbax checkpoint under a checkpoint directory -> <OUT_DIR>/<name>.pth
    python orbax_bridge.py dir bench_ckpts bench_ckpts_torch

``to-pth`` keeps the parameters and the BatchNorm statistics
(``state_dict_from_jax``) and drops the optimizer state, which the port's
resume cannot take; the metadata's keys go to the top level of the ``.pth``,
as the port's trainer writes them. A hybrid tree of router and fusion only
becomes the hybrid ``.pth`` the port's trainer writes. ``to-orbax`` builds
the JAX model from the ``.pth``'s arch metadata (defaults: the serving
presets), maps the state dict onto it with ``convert_state_dict`` and writes
the tree (``{"params", ["batch_stats"]}``) and ``metadata.json``. ``dir``
names every entry it could not convert (a dangling symlink, a directory it
cannot read) and then exits with 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # pure host work

# torch before jax: importing torch after jax's CPU runtime started has
# deadlocked the next jax dispatch on some hosts (two OpenMP runtimes)
import torch  # noqa: E402

MODELS = ("diffusion", "nafnet", "expert", "hybrid", "tiny")
HYBRID_GROUPS = ("nafnet", "diffusion_unet", "router", "fusion")


def _variables(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The variables of an orbax tree, whichever writer made it: a
    trainer's ``{"params", "opt_state", ["extra": {"batch_stats"}]}``, the
    converter's ``{"params", ["batch_stats"]}`` or hybrid groups without a
    ``params`` level, or ``{"variables": ...}``."""
    if "variables" in tree:
        return dict(tree["variables"])
    if "params" in tree:
        variables = {"params": tree["params"]}
        bs = tree.get("batch_stats") or (tree.get("extra") or {}).get("batch_stats")
        if bs:
            variables["batch_stats"] = bs
        return variables
    return {"params": tree}


def to_pth(src_dir: str, out_pth: str) -> Dict[str, Any]:
    """Convert the orbax checkpoint ``src_dir`` into the port's ``out_pth``;
    returns what was written (keys, values, what was dropped)."""
    import jax
    import numpy as np

    from midd_tpu.utils.checkpoint import load_checkpoint
    from midd_tpu_torch.convert.from_jax import state_dict_from_jax
    from midd_tpu_torch.utils.checkpoint import save_checkpoint

    tree, meta = load_checkpoint(src_dir)
    variables = jax.tree_util.tree_map(np.asarray, _variables(tree))
    kept = {"params", "batch_stats", "extra", "variables"}
    dropped = sorted(set(tree) - kept) if kept & set(tree) else []
    sd = state_dict_from_jax(variables)
    save_checkpoint(out_pth, sd, metadata=meta)
    n = sum(int(v.numel()) for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    print(f"{src_dir} -> {out_pth}: {len(sd)} tensors, {n:,} values"
          + (f"; dropped {', '.join(dropped)} (the port's resume takes no optax state)"
             if dropped else ""), flush=True)
    return {"tensors": len(sd), "values": n, "dropped": dropped, "metadata": sorted(meta)}


def _cfg(cls, meta: Dict[str, Any], default=None):
    """A JAX config dataclass from the metadata keys that name its fields
    (lists back to tuples), the rest from ``default``."""
    base = default if default is not None else cls()
    kw = {f.name: tuple(meta[f.name]) if isinstance(meta[f.name], list) else meta[f.name]
          for f in dataclasses.fields(cls) if f.name in meta}
    return dataclasses.replace(base, **kw)


def _templates(model: str, meta: Dict[str, Any], sd: Dict[str, Any]):
    """(JAX module, example inputs) per parameter group: one unnamed group
    for a single model, the prefixes present in ``sd`` for a hybrid."""
    import jax.numpy as jnp

    from midd_tpu import config
    from midd_tpu import models as jm

    x0 = jnp.zeros((1, 64, 64, 1), jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    if model == "diffusion":
        return {None: (jm.UNetDiffusion(_cfg(config.DiffusionUNetConfig, meta, config.SERVE_DIFFUSION)),
                       (x0, x0, t0))}
    if model == "nafnet":
        return {None: (jm.EnhancedNAFNet(_cfg(config.NAFNetConfig, meta, config.SERVE_NAFNET)), (x0,))}
    if model == "expert":
        return {None: (jm.ExpertDenoiser(_cfg(config.ExpertConfig, meta, config.SERVE_EXPERT)), (x0,))}
    if model == "tiny":
        return {None: (jm.TinyUNet(_cfg(config.TinyUNetConfig, meta, config.TINY_UNET)), (x0, t0, x0))}
    fusion = _cfg(config.FusionConfig, meta.get("fusion_params") or {})
    groups = {
        "nafnet": (jm.EnhancedNAFNet(_cfg(config.NAFNetConfig, meta.get("nafnet_params") or {})), (x0,)),
        "diffusion_unet": (jm.UNetDiffusion(_cfg(config.DiffusionUNetConfig,
                                                 meta.get("diffusion_params") or {})), (x0, x0, t0)),
        "router": (jm.NoiseAnalyzer(_cfg(config.RouterConfig, meta.get("router_params") or {})), (x0,)),
        "fusion": (jm.FusionModule(fusion), (x0,) * (4 if fusion.sees_expert else 3)),
    }
    present = {k.split(".", 1)[0] for k in sd}
    if not {"router", "fusion"} <= present or not present <= set(HYBRID_GROUPS):
        raise KeyError(f"a hybrid state dict holds router and fusion weights and at most "
                       f"{HYBRID_GROUPS}; this one holds {sorted(present)}")
    return {g: groups[g] for g in HYBRID_GROUPS if g in present}


def to_orbax(in_pth: str, out_dir: str, model: str) -> Dict[str, Any]:
    """Convert a port (or reference) ``.pth`` into the orbax checkpoint
    ``out_dir`` for the JAX ``model``; returns what was written."""
    import jax

    from midd_tpu.convert.torch_import import convert_state_dict
    from midd_tpu.utils.checkpoint import save_checkpoint

    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    ckpt = torch.load(in_pth, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    meta = {k: v for k, v in ckpt.items() if not k.endswith("state_dict")}
    key = jax.random.PRNGKey(0)
    groups = {}
    for prefix, (module, args) in _templates(model, meta, sd).items():
        sub = sd if prefix is None else {k[len(prefix) + 1:]: v for k, v in sd.items()
                                         if k.startswith(prefix + ".")}
        groups[prefix] = convert_state_dict(sub, jax.jit(module.init)(key, *args))
    tree = groups[None] if None in groups else {"params": {g: v["params"] for g, v in groups.items()}}
    save_checkpoint(out_dir, tree, meta)
    n = sum(x.size for x in jax.tree_util.tree_leaves(tree))
    print(f"{in_pth} -> {out_dir} ({model}): {n:,} values, metadata keys {sorted(meta)}", flush=True)
    return {"values": n, "groups": sorted(g for g in groups if g), "metadata": sorted(meta)}


def convert_dir(src_dir: str, out_dir: str) -> List[str]:
    """Convert every orbax checkpoint (a directory holding ``tree/``) under
    ``src_dir``, at any depth, into ``<out_dir>/<relative path>.pth``.
    Returns the entries that could not be converted (each named on
    stderr): dangling symlinks and directories that fail to load."""
    failed: List[str] = []

    def visit(rel: str) -> None:
        path = os.path.join(src_dir, rel)
        if not os.path.exists(path):
            failed.append(rel)
            print(f"cannot read {path}: "
                  + (f"a dangling symlink to {os.readlink(path)}" if os.path.islink(path)
                     else "missing"), file=sys.stderr, flush=True)
            return
        if not os.path.isdir(path):
            return
        if os.path.isdir(os.path.join(path, "tree")):
            try:
                to_pth(path, os.path.join(out_dir, rel + ".pth"))
            except Exception as e:  # noqa: BLE001  name it, go on with the rest
                failed.append(rel)
                print(f"cannot convert {path}: {e!r}", file=sys.stderr, flush=True)
            return
        for name in sorted(os.listdir(path)):
            visit(os.path.join(rel, name) if rel else name)

    if not os.path.isdir(src_dir):
        raise NotADirectoryError(src_dir)
    visit("")
    return failed


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("to-pth", help="one orbax checkpoint directory -> a port .pth")
    p.add_argument("src_dir")
    p.add_argument("out_pth")
    p = sub.add_parser("to-orbax", help="a port (or reference) .pth -> an orbax checkpoint directory")
    p.add_argument("in_pth")
    p.add_argument("out_dir")
    p.add_argument("--model", required=True, choices=MODELS)
    p = sub.add_parser("dir", help="every orbax checkpoint under a directory -> <OUT_DIR>/<name>.pth")
    p.add_argument("src_dir")
    p.add_argument("out_dir")
    args = ap.parse_args(argv)

    if args.mode == "to-pth":
        to_pth(args.src_dir, args.out_pth)
    elif args.mode == "to-orbax":
        to_orbax(args.in_pth, args.out_dir, args.model)
    else:
        failed = convert_dir(args.src_dir, args.out_dir)
        if failed:
            print(f"not converted ({len(failed)}): {', '.join(failed)}", file=sys.stderr, flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
