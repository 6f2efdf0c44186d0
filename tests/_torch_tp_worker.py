"""One rank of the port's tensor-parallel training checks on the CPU
(tests/test_torch_tp_train.py), under torchrun over gloo. It imports torch
and the port, never jax.

    torchrun --standalone --nproc_per_node 2 tests/_torch_tp_worker.py tp2 JOB OUT_DIR CLEAN NOISY

(i) split layers at tp 2 in fp64 (a convolution, a depthwise one, a
``ConvTranspose2d``, ``fused_updown``'s derived convolution and a
``Linear``, behind a layer that stays whole; and a tiny NAFNet whose
per-channel ``beta``/``gamma`` split) against single-process autograd on
the same rank: the output, the input's gradient and every parameter's
gradient, slice by slice; (ii) one tiny NAFNet step at (1, 1, 2) from the
job's weights on its batch, with (iii) the norm that the clip took, and
the same step with the whole parameters' gradients a last bit apart on
the two ranks; (vi)
the recipes CLI at ``--mesh 1,1,2`` for nafnet, diffusion, expert and
hybrid (tiny preset, 16², one epoch, ``tp_min_size`` 64) in
``OUT_DIR/cli/<model>``.

    torchrun --standalone --nproc_per_node 4 tests/_torch_tp_worker.py tp4 JOB OUT_DIR

(ii) the same step at (2, 1, 2); (iv) one epoch at (2, 1, 2) on the job's
synthetic dataset, ``Trainer.save``, then that checkpoint resumed at
(4, 1, 1) and at (1, 1, 4), each checked against the file
(``restored_matches``) and trained for one more epoch.

Each rank writes ``OUT_DIR/<mode>.rank<R>.pt``.
"""

import contextlib
import copy
import dataclasses
import os
import sys

import torch
import torch.distributed as dist
import torch.nn as nn

TP_MIN_SIZE = 64  # splits real layers at the tiny widths
CLI_MODELS = ("nafnet", "diffusion", "expert", "hybrid")


class Chain(nn.Module):
    """One layer of each kind that the tp rule splits, behind one it keeps
    whole (its gradient needs the copy-in's all-reduce)."""

    def __init__(self):
        super().__init__()
        from midd_tpu_torch.models.blocks import ConvTransposeTorch, Linear

        self.pre = nn.Conv2d(2, 4, 1)  # 8 weights: whole
        self.conv = nn.Conv2d(4, 8, 3, padding=1)
        self.dw = nn.Conv2d(8, 8, 3, padding=1, groups=8)
        self.up = ConvTransposeTorch(8, 8, 4, 2, 1)
        self.updown = ConvTransposeTorch(8, 8, 4, 2, 1)
        self.lin = Linear(8, 16)

    def forward(self, x):
        from midd_tpu_torch.models.unet_diffusion import fused_updown

        h = self.dw(torch.tanh(self.conv(self.pre(x))))
        h = fused_updown(self.updown, self.up(torch.tanh(h)))
        return h, self.lin(h.mean((2, 3)))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest entry of ``want`` (over 1
    where that is smaller)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def autograd_errors(model: nn.Module, x: torch.Tensor, min_size: int, group) -> dict:
    """``model`` split over ``group`` against a single-process copy, fp64:
    the outputs', dx's and each parameter gradient's ``_err`` (a split
    parameter's against its slice of the whole gradient); with the split
    count and the split names."""
    from midd_tpu_torch.parallel.tp import shard_over_group

    model = model.double()
    ref = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(7)
    xr, xs = x.double().clone().requires_grad_(), x.double().clone().requires_grad_()
    outs_r = _outputs(ref(xr))
    weights = [torch.randn(o.shape, generator=gen, dtype=torch.float64) for o in outs_r]
    sum(((o * w).sum() for o, w in zip(outs_r, weights))).backward()
    shards = shard_over_group(model, group, min_size)
    outs_s = _outputs(model(xs))
    sum(((o * w).sum() for o, w in zip(outs_s, weights))).backward()
    ref_grads = dict(ref.named_parameters())
    grads = {}
    for name, p, dim in zip(shards.param_names, shards.params(), shards.param_dims()):
        want = ref_grads[name].grad
        if dim is not None:
            want = want.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)]
        grads[name] = _err(p.grad, want)
    return {"out": max(_err(a, b) for a, b in zip(outs_s, outs_r)),
            "dx": _err(xs.grad, xr.grad), "grads": grads, "n_sharded": shards.n_sharded,
            "split": sorted(n for n, d in shards.dims.items() if d is not None)}


def layer_checks() -> dict:
    from midd_tpu_torch.models.blocks import init_weights
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.train import recipes

    group = dist.group.WORLD
    torch.manual_seed(0)
    out = {"chain": autograd_errors(Chain(), torch.randn(2, 2, 8, 8), TP_MIN_SIZE, group)}
    naf = init_weights(EnhancedNAFNet(recipes.TINY_NAFNET), torch.Generator().manual_seed(1))
    with torch.no_grad():
        for blk in naf.modules():
            if hasattr(blk, "beta"):
                blk.beta.normal_()
                blk.gamma.normal_()
    out["nafnet_min16"] = autograd_errors(naf, torch.rand(2, 1, 16, 16), 16, group)
    return out


def _trainer(job, mesh_shape, ckpt_dir, name="nafnet", epochs=1, batch=None):
    from tests import _torch_dp_worker as dpw

    job = {**job, "batch": batch or job["batch"]}
    trainer = dpw._trainer(name, job, ckpt_dir, mesh_shape=mesh_shape, tp_min_size=TP_MIN_SIZE)
    trainer.cfg.epochs = epochs
    trainer.eval_fn = lambda model, extra, clean, noisy: model(noisy)
    return trainer


@contextlib.contextmanager
def recorded_norms():
    """While the block runs, the trainer's clip records each norm it takes
    in the yielded list."""
    from midd_tpu_torch.train import trainer as tt

    norms, clip = [], tt.clip_by_global_norm_

    def recorded(*args, **kw):
        norms.append(float(clip(*args, **kw)))
        return norms[-1]

    tt.clip_by_global_norm_ = recorded
    try:
        yield norms
    finally:
        tt.clip_by_global_norm_ = clip


def step_record(job, mesh_shape, out_dir) -> dict:
    """One NAFNet step at ``mesh_shape`` on this rank's rows of the job's
    batch: the loss, the unsharded state and the clipped gradients after it,
    the clip's norm, this rank's rows and the split count."""
    trainer = _trainer(job, mesh_shape, os.path.join(out_dir, "unused"))
    start, n = trainer.rows
    clean, noisy = job["nafnet"]["clean"], job["nafnet"]["noisy"]
    with recorded_norms() as norms:
        loss = trainer.train_step((clean[start:start + n], noisy[start:start + n]))
    state, _ = trainer.state_dicts()
    shards, grads = trainer.shards, {}
    for name, p, dim in zip(shards.param_names, shards.params(), shards.param_dims()):
        parts = [torch.empty_like(p.grad) for _ in range(dist.get_world_size(shards.group))]
        dist.all_gather(parts, p.grad, group=shards.group)
        grads[name] = p.grad.clone() if dim is None else torch.cat(parts, dim)
    return {"loss": loss, "state": {k: v.clone() for k, v in state.items()}, "grads": grads,
            "norm": norms[-1], "rows": trainer.rows, "n_sharded": shards.n_sharded}


def drift_record(job, out_dir) -> dict:
    """One NAFNet step at (1, 1, 2) whose whole (unsplit) parameters' gradients
    this rank moves by rank x 1e-6 before the update, as a backward kernel
    that sums with atomics moves them by its last bit: the unsharded state
    after it, which the tp mean of those gradients keeps equal on both
    ranks."""
    trainer = _trainer(job, (1, 1, 2), os.path.join(out_dir, "unused"))
    rank = dist.get_rank()
    for p, dim in zip(trainer.shards.params(), trainer.shards.param_dims()):
        if dim is None:
            p.register_hook(lambda g: g + rank * 1e-6)
    trainer.train_step((job["nafnet"]["clean"], job["nafnet"]["noisy"]))
    state, _ = trainer.state_dicts()
    return {k: v.clone() for k, v in state.items()}


def cli(out_dir, clean_dir, noisy_dir) -> dict:
    """The recipes CLI at ``--mesh 1,1,2`` with ``tp_min_size`` 64; the split
    count and the trained ``.pth``'s path of each model."""
    from midd_tpu_torch.train import recipes
    from midd_tpu_torch.train import trainer as tt
    from tests._torch_dp_worker import cli_argv

    defaults, split = recipes.default_train_config, tt.shard_over_group
    counts = {}
    recipes.default_train_config = lambda model="diffusion": dataclasses.replace(defaults(model),
                                                                                   tp_min_size=TP_MIN_SIZE)

    def counted(*args, **kw):
        shards = split(*args, **kw)
        counts[current] = shards.n_sharded
        return shards

    tt.shard_over_group = counted
    here = os.getcwd()
    for current in CLI_MODELS:
        cwd = os.path.join(out_dir, "cli", current)
        os.makedirs(cwd, exist_ok=True)
        os.chdir(cwd)
        try:
            recipes.main(cli_argv(current, clean_dir, noisy_dir) + ["--mesh", "1,1,2"])
        finally:
            os.chdir(here)
    recipes.default_train_config, tt.shard_over_group = defaults, split
    return counts


def resume_runs(job, out_dir) -> dict:
    """(iv): one epoch at (2, 1, 2), saved, then resumed at (4, 1, 1) and
    (1, 1, 4) for one more epoch each."""
    from midd_tpu_torch.train.data import SyntheticPairedDataset
    from tests._torch_dp_worker import restored_matches

    def dataset():
        return SyntheticPairedDataset(job["dataset"], is_train=False, seed=7)

    batch = job["dataset"].shape[0]
    src = _trainer(job, (2, 1, 2), os.path.join(out_dir, "src"), batch=batch)
    ds = dataset()
    src.fit(ds, [ds[0]], verbose=False)
    out = {"path": src.save({"tag": "src"}), "src_losses": src.state.history["losses"], "resumed": {}}
    for mesh_shape in ((4, 1, 1), (1, 1, 4)):
        tr = _trainer(job, mesh_shape, os.path.join(out_dir, f"out_{mesh_shape}"), epochs=2, batch=batch)
        tr.resume(out["path"])
        matches, epoch = restored_matches(tr, out["path"]), tr.state.epoch
        ds = dataset()
        tr.fit(ds, [ds[0]], verbose=False)
        out["resumed"][mesh_shape] = {"matches": matches, "epoch": epoch, "losses": tr.state.history["losses"]}
    return out


def main() -> None:
    from midd_tpu_torch.parallel import init_distributed

    mode, job_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    assert init_distributed(backend="gloo")
    job = torch.load(job_path, weights_only=False)
    if mode == "tp2":
        out = {"layers": layer_checks(), "step": step_record(job, (1, 1, 2), out_dir),
               "drift": drift_record(job, out_dir), "cli": cli(out_dir, *sys.argv[4:6])}
    else:
        out = {"step": step_record(job, (2, 1, 2), out_dir), "resume": resume_runs(job, out_dir)}
    torch.save(out, os.path.join(out_dir, f"{mode}.rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
