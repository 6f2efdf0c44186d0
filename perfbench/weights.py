"""Seeded weights for the four checkpoints, drawn on the device.

No trained weights of the served models exist, so every run draws its own
from ``--seed``: one standard normal a checkpoint from a ``torch.Generator``
on the card, shaped into the checkpoint's tensors by a per-tensor scale and
offset (a few large calls a checkpoint, not one draw a leaf). The draw keeps every answer
inside (0, 1), as a trained model's is, so the comparison with the reference
sees the networks' arithmetic and not a clamp:

- convolution and linear weights LeCun-normal (He-normal in the expert,
  ``GAIN``); an output layer's scaled by
  ``HEAD_SCALE`` so that it adds a correction of a few tenths of the range
  (the NAFNet's ending is residual to its input, the expert's and the
  fusion's heads sit at mid-grey);
- biases and norm offsets small normals, norm scales and BatchNorm running
  variances near 1; NAFBlock ``beta`` and ``gamma`` nonzero, so that every
  block (and its two LayerNorms) reaches the answer.

The checkpoints are written as the reference service's ``.pth`` files with
the metadata the port reads its architecture from; ``hybrid.pth`` holds the
router and the fusion only, as the hybrid trainer saves it.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn as nn

from perfbench.reference import models as ref

# weight gain of each checkpoint's layers: He's for the expert, whose ReLU
# layers meet no normalisation that rescales them (its BatchNorms hold fixed
# running statistics), LeCun's for the normalised networks
GAIN = {"diffusion": 1.0, "nafnet": 1.0, "expert": 2.0 ** 0.5, "hybrid": 1.0}
# output layer -> (weight scale on top of the gain, bias)
HEAD_SCALE = {
    "diffusion": {"out_conv.2": (1.0, 0.0)},
    "nafnet": {"ending": (0.1, 0.0)},
    "expert": {"outc": (0.3, 0.5)},
    "hybrid": {"fusion.out_conv": (0.3, 0.5), "router.out_conv": (1.0, 0.0)},
}


def _rules(name: str, model: nn.Module) -> Dict[str, Tuple[float, float]]:
    """(std, mean) of each floating tensor of ``model``'s state dict."""
    rules = {}
    for prefix, mod in model.named_modules():
        p = f"{prefix}." if prefix else ""
        head_w, head_b = HEAD_SCALE[name].get(prefix, (1.0, None))
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose2d) else w[0].numel()
            rules[p + "weight"] = (GAIN[name] * head_w * fan_in ** -0.5, 0.0)
            if mod.bias is not None:
                rules[p + "bias"] = (0.0, head_b) if head_b is not None else (0.02, 0.0)
        elif isinstance(mod, (nn.GroupNorm, ref.LayerNorm2d, nn.BatchNorm2d)):
            rules[p + "weight"] = (0.1, 1.0)
            rules[p + "bias"] = (0.1, 0.0)
            if isinstance(mod, nn.BatchNorm2d):
                rules[p + "running_mean"] = (0.1, 0.0)
                rules[p + "running_var"] = (0.1, 1.0)
        elif isinstance(mod, ref.NAFBlock):
            rules[p + "beta"] = (0.1, 0.0)
            rules[p + "gamma"] = (0.1, 0.0)
    return rules


def draw(cfg: Dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{checkpoint: state dict} for the configuration's four checkpoints,
    fp32 on ``device``, the same for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    states = {}
    for name, model in ref.build(cfg, "meta").items():
        shapes = {k: v.shape for k, v in model.state_dict().items()}
        rules = _rules(name, model)
        floating = [k for k in shapes if k in rules]
        missing = set(shapes) - set(floating) - {k for k in shapes if k.endswith("num_batches_tracked")}
        if missing:
            raise KeyError(f"{name}: no draw rule for {sorted(missing)}")
        counts = torch.tensor([shapes[k].numel() for k in floating], device=device)
        std = torch.repeat_interleave(torch.tensor([rules[k][0] for k in floating], device=device), counts)
        mean = torch.repeat_interleave(torch.tensor([rules[k][1] for k in floating], device=device), counts)
        flat = torch.randn(int(counts.sum()), generator=gen, device=device).mul_(std).add_(mean)
        state = dict(zip(floating, (t.view(shapes[k]) for k, t in zip(floating, flat.split(counts.tolist())))))
        for k in shapes:
            if k.endswith("num_batches_tracked"):
                state[k] = torch.zeros((), dtype=torch.int64, device=device)
        states[name] = {k: state[k] for k in shapes}
    return states


def save(cfg: Dict, states: Dict[str, Dict[str, torch.Tensor]], directory: str) -> None:
    """The four ``.pth`` files, with the metadata a deployment's carry."""
    meta = {
        "diffusion": {**cfg["diffusion"], "noise_steps": cfg["schedule"]["noise_steps"]},
        "nafnet": dict(cfg["nafnet"]),
        "expert": {},
        "hybrid": {"router_params": dict(cfg["router"]), "fusion_params": dict(cfg["fusion"])},
    }
    for name, state in states.items():
        torch.save({"model_state_dict": state, **meta[name]}, os.path.join(directory, f"{name}.pth"))
