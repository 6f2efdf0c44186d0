"""One rank of the port's spatial-parallel training checks on the CPU
(tests/test_torch_sp.py), under torchrun over gloo. It imports torch and the
port, never jax.

    torchrun --standalone --nproc_per_node 2 tests/_torch_sp_worker.py sp2 JOB OUT_DIR CLEAN NOISY

(i) row-split layers at sp 2 in fp64 (3×3 stride 1 and 2, 1×1, depthwise
3×3, the NAFNet's 2×2 stride-2 downsampler, ``ConvTransposeTorch`` k4 s2 p1
and k2 s2, ``fused_updown``'s derived convolution, behind which a GroupNorm
and a ``Linear`` stay whole) on an odd height, against single-process
autograd on the same rank: the output, the input's gradient and every
parameter's gradient after the trainer's reduction over sp; a dynamic
``QuantConv2d`` in fp32, forward only, bit for bit; (ii) one tiny NAFNet
step at (1, 2, 1) from the job's weights on its batch, with (iii) the norm
that the clip took, and the same step with the whole parameters' gradients
a last bit apart on the two ranks; (vi) the recipes CLI at ``--mesh 1,2,1``
for nafnet, diffusion, expert and hybrid (tiny preset, 16², one epoch) in
``OUT_DIR/cli/<model>``; (iv) once the 4-rank launch has marked its
(2, 2, 1) checkpoint ready, that checkpoint resumed at (1, 2, 1) and at
(1, 1, 2), each checked against the file and trained one more epoch.

    torchrun --standalone --nproc_per_node 4 tests/_torch_sp_worker.py sp4 JOB OUT_DIR

(iv) one epoch at (2, 2, 1) on the job's synthetic dataset,
``Trainer.save``, the ready mark, then that checkpoint resumed at
(4, 1, 1); (i) the layers at sp 3 over ranks 0-2; (ii) the step at
(2, 2, 1).

Each rank writes ``OUT_DIR/<mode>.rank<R>.pt``.
"""

import copy
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.nn as nn

CLI_MODELS = ("nafnet", "diffusion", "expert", "hybrid")
READY = "src.ready"  # the 4-rank launch's mark: its (2, 2, 1) checkpoint is written
READY_TIMEOUT_S = 240


class Chain(nn.Module):
    """One convolution of each kind that the sp split takes, with a norm
    and a ``Linear`` that stay whole."""

    def __init__(self):
        super().__init__()
        from midd_tpu_torch.models.blocks import Conv2d, ConvTransposeTorch, GroupNorm32, Linear

        self.conv = Conv2d(2, 4, 3)
        self.down = Conv2d(4, 8, 3, stride=2)
        self.pw = Conv2d(8, 8, 1)
        self.dw = Conv2d(8, 8, 3, groups=8)
        self.norm = GroupNorm32(4, 8)
        self.naf_down = Conv2d(8, 8, 2, stride=2, padding=0)
        self.up = ConvTransposeTorch(8, 8, 4, 2, 1)
        self.updown = ConvTransposeTorch(8, 8, 4, 2, 1)
        self.up2 = ConvTransposeTorch(8, 4, 2, 2)
        self.lin = Linear(4, 6)

    def forward(self, x):
        from midd_tpu_torch.models.unet_diffusion import fused_updown

        h = self.down(torch.tanh(self.conv(x)))
        h = self.norm(self.dw(torch.tanh(self.pw(h))))
        h = self.up(torch.tanh(self.naf_down(h)))
        h = self.up2(torch.tanh(fused_updown(self.updown, h)))
        return h, self.lin(h.mean((2, 3)))


class Quant(nn.Module):
    """Dynamic int8 convolutions, 3×3 stride 1 and 2 (the UNet's ResBlock
    and downsampler kinds)."""

    def __init__(self):
        super().__init__()
        from midd_tpu_torch.ops.qconv import QuantConv2d

        self.a = QuantConv2d(3, 8, 3, mode="dynamic")
        self.b = QuantConv2d(8, 8, 3, stride=2, mode="dynamic")

    def forward(self, x):
        return self.b(torch.tanh(self.a(x)))


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest entry of ``want`` (over 1
    where that is smaller)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def autograd_errors(model: nn.Module, x: torch.Tensor, group) -> dict:
    """``model`` row-split over ``group`` against a single-process copy,
    fp64: the outputs', dx's and each parameter gradient's ``_err``, the
    gradients reduced over the group as the trainer reduces them; with the
    split layers' parameter names."""
    from midd_tpu_torch.parallel.sp import shard_rows_over_group
    from midd_tpu_torch.parallel.train_dp import average_gradients

    model = model.double()
    ref = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(7)
    xr, xs = x.double().clone().requires_grad_(), x.double().clone().requires_grad_()
    outs_r = ref(xr)
    weights = [torch.randn(o.shape, generator=gen, dtype=torch.float64) for o in outs_r]
    sum((o * w).sum() for o, w in zip(outs_r, weights)).backward()
    shards = shard_rows_over_group(model, group)
    outs_s = model(xs)
    sum((o * w).sum() for o, w in zip(outs_s, weights)).backward()
    average_gradients(torch.zeros(()), shards.params(), group, shards.param_summed())
    ref_grads = dict(ref.named_parameters())
    grads = {n: _err(p.grad, ref_grads[n].grad) for n, p in zip(shards.param_names, shards.params())}
    return {"out": max(_err(a, b) for a, b in zip(outs_s, outs_r)), "dx": _err(xs.grad, xr.grad),
            "grads": grads, "summed": list(shards.summed), "shapes": [tuple(o.shape) for o in outs_s]}


def quant_equal(x: torch.Tensor, group) -> dict:
    """A dynamic int8 module row-split over ``group`` against the whole one,
    fp32, forward (with gradients on: without, the rank form computes every
    row): whether the outputs are equal bit for bit, and the row-split
    module's output without gradients."""
    from midd_tpu_torch.parallel.sp import shard_rows_over_group

    torch.manual_seed(3)
    model = Quant()
    with torch.no_grad():
        want = model(x)
    shard_rows_over_group(model, group)
    got = model(x).detach()
    with torch.no_grad():
        whole = model(x)
    return {"equal": torch.equal(got, want), "max_abs_diff": (got - want).abs().max().item(),
            "shape": tuple(got.shape), "no_grad_equal": torch.equal(whole, want)}


def layer_checks(group, height: int) -> dict:
    torch.manual_seed(0)
    return {"chain": autograd_errors(Chain(), torch.randn(2, 2, height, 10), group),
            "quant": quant_equal(torch.randn(2, 3, height, 9), group)}


def _trainer(job, mesh_shape, ckpt_dir, epochs=1, batch=None):
    from tests import _torch_tp_worker as tpw

    return tpw._trainer(job, mesh_shape, ckpt_dir, epochs=epochs, batch=batch)


def step_record(job, mesh_shape, out_dir) -> dict:
    """One NAFNet step at ``mesh_shape`` on this rank's rows of the job's
    batch: the loss, the unsharded state and the reduced, clipped gradients
    after it, the clip's norm, this rank's rows and its image sharding."""
    from midd_tpu_torch.parallel.mesh import image_sharding
    from tests._torch_tp_worker import recorded_norms

    trainer = _trainer(job, mesh_shape, os.path.join(out_dir, "unused"))
    start, n = trainer.rows
    clean, noisy = job["nafnet"]["clean"], job["nafnet"]["noisy"]
    with recorded_norms() as norms:
        loss = trainer.train_step((clean[start:start + n], noisy[start:start + n]))
    state, _ = trainer.state_dicts()
    shards = trainer.shards
    return {"loss": loss, "state": {k: v.clone() for k, v in state.items()},
            "grads": {name: p.grad.clone() for name, p in zip(shards.param_names, shards.params())},
            "norm": norms[-1], "rows": trainer.rows, "image_sharding": image_sharding(job["batch"], trainer.mesh),
            "summed": len(shards.summed)}


def drift_record(job, out_dir) -> dict:
    """One NAFNet step at (1, 2, 1) whose whole (not row-split) parameters'
    gradients this rank moves by rank x 1e-6 before the update, as a
    backward kernel that sums with atomics moves them by its last bit: the
    state after it, which the sp mean of those gradients keeps equal on
    both ranks."""
    trainer = _trainer(job, (1, 2, 1), os.path.join(out_dir, "unused"))
    rank = dist.get_rank()
    for p, summed in zip(trainer.shards.params(), trainer.shards.param_summed()):
        if not summed:
            p.register_hook(lambda g: g + rank * 1e-6)
    trainer.train_step((job["nafnet"]["clean"], job["nafnet"]["noisy"]))
    state, _ = trainer.state_dicts()
    return {k: v.clone() for k, v in state.items()}


def cli(out_dir, clean_dir, noisy_dir) -> dict:
    """The recipes CLI at ``--mesh 1,2,1``: the number of row-split
    parameters of each model."""
    from midd_tpu_torch.train import recipes
    from midd_tpu_torch.train import trainer as tt
    from tests._torch_dp_worker import cli_argv

    split, counts = tt.shard_rows_over_group, {}

    def counted(*args, **kw):
        shards = split(*args, **kw)
        counts[current] = len(shards.summed)
        return shards

    tt.shard_rows_over_group = counted
    here = os.getcwd()
    try:
        for current in CLI_MODELS:
            cwd = os.path.join(out_dir, "cli", current)
            os.makedirs(cwd, exist_ok=True)
            os.chdir(cwd)
            try:
                recipes.main(cli_argv(current, clean_dir, noisy_dir) + ["--mesh", "1,2,1"])
            finally:
                os.chdir(here)
    finally:
        tt.shard_rows_over_group = split
    return counts


def _dataset(job):
    from midd_tpu_torch.train.data import SyntheticPairedDataset

    return SyntheticPairedDataset(job["dataset"], is_train=False, seed=7)


def resumed_at(job, path, mesh_shape, out_dir) -> dict:
    """``path`` resumed at ``mesh_shape``, checked against the file, then
    trained one more epoch."""
    from tests._torch_dp_worker import restored_matches

    tr = _trainer(job, mesh_shape, os.path.join(out_dir, f"out_{mesh_shape}"), epochs=2,
                  batch=job["dataset"].shape[0])
    tr.resume(path)
    matches, epoch = restored_matches(tr, path), tr.state.epoch
    ds = _dataset(job)
    tr.fit(ds, [ds[0]], verbose=False)
    return {"matches": matches, "epoch": epoch, "losses": tr.state.history["losses"]}


def source_run(job, out_dir) -> dict:
    """(iv)'s source: one epoch at (2, 2, 1), saved and marked ready."""
    src = _trainer(job, (2, 2, 1), os.path.join(out_dir, "src"), batch=job["dataset"].shape[0])
    ds = _dataset(job)
    src.fit(ds, [ds[0]], verbose=False)
    path = src.save({"tag": "src"})
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, READY + ".tmp"), "w") as f:
            f.write(path)
        os.replace(os.path.join(out_dir, READY + ".tmp"), os.path.join(out_dir, READY))
    return {"path": path, "src_losses": src.state.history["losses"]}


def wait_ready(out_dir) -> str:
    mark, deadline = os.path.join(out_dir, READY), time.time() + READY_TIMEOUT_S
    while not os.path.exists(mark):
        if time.time() > deadline:
            raise TimeoutError(f"no {READY} from the 4-rank launch in {READY_TIMEOUT_S} s")
        time.sleep(0.5)
    with open(mark) as f:
        return f.read()


def main() -> None:
    from midd_tpu_torch.parallel import init_distributed

    mode, job_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    assert init_distributed(backend="gloo")
    job = torch.load(job_path, weights_only=False)
    if mode == "sp2":
        out = {"layers": layer_checks(dist.group.WORLD, 13), "step": step_record(job, (1, 2, 1), out_dir),
               "drift": drift_record(job, out_dir), "cli": cli(out_dir, *sys.argv[4:6])}
        path = wait_ready(out_dir)
        out["resume"] = {m: resumed_at(job, path, m, out_dir) for m in ((1, 2, 1), (1, 1, 2))}
    else:
        out = {"resume_src": source_run(job, out_dir)}
        out["resume"] = {(4, 1, 1): resumed_at(job, out["resume_src"]["path"], (4, 1, 1), out_dir)}
        three = dist.new_group([0, 1, 2])  # every rank takes part in making it
        if dist.get_rank() < 3:
            out["layers"] = layer_checks(three, 11)
        out["step"] = step_record(job, (2, 2, 1), out_dir)
    torch.save(out, os.path.join(out_dir, f"{mode}.rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
