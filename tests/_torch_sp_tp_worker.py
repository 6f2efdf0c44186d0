"""One rank of the port's checks of training at sp and tp together on the CPU
(tests/test_torch_sp_tp_train.py), under torchrun over gloo. It imports
torch and the port, never jax.

    torchrun --standalone --nproc_per_node 4 tests/_torch_sp_tp_worker.py sptp4 JOB OUT_DIR CLEAN NOISY

(i) the layers of ``Chain`` at (sp 2, tp 2) in fp64 on an odd height,
against single-process autograd on the same rank: the output, the input's
gradient and every parameter's gradient (a split one's against its slice)
after the step's reductions; (ii) one tiny NAFNet step at (1, 2, 2) from
the job's weights on its batch, with (iv) the norm that the clip took, and
the same step with the whole parameters' gradients a last bit apart on the
ranks; (iii) one tiny diffusion UNet step at (1, 2, 2) on the job's draws;
(vii) the NAFNet step with ``TrainConfig(remat=True)``; (vi) the recipes
CLI at ``--mesh 1,2,2`` for every recipe (tiny preset, 16², one epoch,
``tp_min_size`` 64) in ``OUT_DIR/cli/<model>``;
(v) the job's one-process ``.pth`` resumed at (1, 2, 2), then, once the
8-rank launch has marked its (2, 2, 2) checkpoint ready, that checkpoint
resumed at (1, 2, 2); then the ranks part into two process groups of two,
which resume it at (1, 1, 2) (ranks 0-1) and at (1, 2, 1) (ranks 2-3).
Every resume is checked against its file and trained one more epoch.

    torchrun --standalone --nproc_per_node 8 tests/_torch_sp_tp_worker.py sptp8 JOB OUT_DIR

(v) one epoch at (2, 2, 2) on the job's synthetic dataset,
``Trainer.save``, the ready mark; (ii) the NAFNet step at (2, 2, 2).

Each rank writes ``OUT_DIR/<mode>.rank<R>.pt``.
"""

import copy
import dataclasses
import os
import sys

import torch
import torch.distributed as dist
import torch.nn as nn

from tests import _torch_dp_worker as dpw
from tests import _torch_sp_worker as spw
from tests import _torch_tp_worker as tpw

CLI_MODELS = ("nafnet", "diffusion", "expert", "hybrid", "cddpm", "tiny")
CHAIN_MIN_SIZE = 8  # splits every layer of ``Chain`` with 8 or more weights, ``beta`` and ``gamma`` too
PAIRS = {0: (1, 1, 2), 1: (1, 1, 2), 2: (1, 2, 1), 3: (1, 2, 1)}  # (v): each rank's mesh after the parting


class Chain(spw.Chain):
    """sp's chain of every convolution kind (3×3 stride 1 and 2, 1×1,
    depthwise 3×3, the NAFNet's 2×2 stride-2 downsampler, ``ConvTransposeTorch``
    k4 s2 p1 and k2 s2, ``fused_updown``'s derived convolution, a GroupNorm
    and a ``Linear``), with a per-channel ``beta`` and ``gamma`` as a
    NAFBlock holds them, which the tp rule splits and no layer owns."""

    def __init__(self):
        super().__init__()
        self.beta = nn.Parameter(torch.randn(1, 8, 1, 1))
        self.gamma = nn.Parameter(torch.randn(1, 8, 1, 1))

    def forward(self, x):
        from midd_tpu_torch.models.unet_diffusion import fused_updown

        h = self.down(torch.tanh(self.conv(x)))
        h = self.norm(self.dw(torch.tanh(self.pw(h)))) * self.beta
        h = self.up(torch.tanh(self.naf_down(h)) + self.gamma)
        h = self.up2(torch.tanh(fused_updown(self.updown, h)))
        return h, self.lin(h.mean((2, 3)))


def _groups(mesh_shape):
    from midd_tpu_torch.parallel.mesh import make_mesh
    from midd_tpu_torch.parallel.train_dp import sp_group, tp_group

    dp, sp, tp = mesh_shape
    mesh = make_mesh(dp * sp * tp, tp=tp, sp=sp, device_type="cpu")
    return sp_group(mesh), tp_group(mesh)


def layer_checks(height: int) -> dict:
    """``Chain`` split over (sp 2, tp 2) against a single-process copy, fp64:
    the outputs', dx's and each parameter gradient's ``spw._err`` after the
    step's reductions (sp, then tp for the whole parameters), a split
    parameter's against its slice of the whole gradient; with the split
    and the row-split names."""
    from midd_tpu_torch.parallel.sp import shard_rows_over_group
    from midd_tpu_torch.parallel.tp import shard_over_group
    from midd_tpu_torch.parallel.train_dp import average_gradients

    sp, tp = _groups((1, 2, 2))
    torch.manual_seed(0)
    model, x = Chain().double(), torch.randn(2, 2, height, 10, dtype=torch.float64)
    ref = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(7)
    xr, xs = x.clone().requires_grad_(), x.clone().requires_grad_()
    outs_r = ref(xr)
    weights = [torch.randn(o.shape, generator=gen, dtype=torch.float64) for o in outs_r]
    sum((o * w).sum() for o, w in zip(outs_r, weights)).backward()
    shards = shard_rows_over_group(model, sp, shard_over_group(model, tp, CHAIN_MIN_SIZE))
    outs_s = model(xs)
    sum((o * w).sum() for o, w in zip(outs_s, weights)).backward()
    params, dims = shards.params(), shards.param_dims()
    average_gradients(torch.zeros(()), params, sp, shards.param_summed())
    average_gradients(torch.zeros(()), [p for p, d in zip(params, dims) if d is None], tp)
    ref_grads, grads = dict(ref.named_parameters()), {}
    for name, p, dim in zip(shards.param_names, params, dims):
        want = ref_grads[name].grad
        if dim is not None:
            want = want.chunk(dist.get_world_size(tp), dim=dim)[dist.get_rank(tp)]
        grads[name] = spw._err(p.grad, want)
    return {"out": max(spw._err(a, b) for a, b in zip(outs_s, outs_r)), "dx": spw._err(xs.grad, xr.grad),
            "grads": grads, "summed": list(shards.summed), "n_sharded": shards.n_sharded,
            "split": sorted(n for n, d in shards.dims.items() if d is not None),
            "shapes": [tuple(o.shape) for o in outs_s]}


def _trainer(job, mesh_shape, ckpt_dir, name="nafnet", epochs=1, batch=None, remat=False):
    """The job's trainer for ``name`` at ``mesh_shape`` (None: one process),
    ``tp_min_size`` 64, fed the job's draws where it has them."""
    job = {**job, "batch": batch or job["batch"]}
    trainer = dpw._trainer(name, job, ckpt_dir, job[name].get("draw"), mesh_shape=mesh_shape, remat=remat,
                           tp_min_size=tpw.TP_MIN_SIZE)
    trainer.cfg.epochs = epochs
    trainer.eval_fn = lambda model, extra, clean, noisy: model(noisy)
    return trainer


def step_record(job, mesh_shape, out_dir, name="nafnet", remat=False) -> dict:
    """One step of ``name`` at ``mesh_shape`` on this rank's rows of the
    job's batch: the loss, the unsharded state after it, the reduced,
    clipped gradients (gathered over tp), the clip's norm, this rank's rows
    and image sharding, and the split and row-split counts."""
    from midd_tpu_torch.parallel.mesh import image_sharding

    trainer = _trainer(job, mesh_shape, os.path.join(out_dir, "unused"), name=name, remat=remat)
    start, n = trainer.rows
    clean, noisy = job[name]["clean"], job[name]["noisy"]
    with tpw.recorded_norms() as norms:
        loss = trainer.train_step((clean[start:start + n], noisy[start:start + n]))
    state, _ = trainer.state_dicts()
    shards, grads = trainer.shards, {}
    for pname, p, dim in zip(shards.param_names, shards.params(), shards.param_dims()):
        parts = [torch.empty_like(p.grad) for _ in range(dist.get_world_size(shards.group))]
        dist.all_gather(parts, p.grad, group=shards.group)
        grads[pname] = p.grad.clone() if dim is None else torch.cat(parts, dim)
    return {"loss": loss, "state": {k: v.clone() for k, v in state.items()}, "grads": grads,
            "norm": norms[-1], "rows": trainer.rows, "image_sharding": image_sharding(job["batch"], trainer.mesh),
            "n_sharded": shards.n_sharded, "summed": len(shards.summed)}


def drift_record(job, out_dir) -> dict:
    """One NAFNet step at (1, 2, 2) whose whole (not tp split) parameters'
    gradients this rank moves by rank x 1e-6 before the update, as a
    backward kernel that sums with atomics moves them by its last bit: the
    unsharded state after it, which the sp and tp reductions keep equal on
    every rank."""
    trainer = _trainer(job, (1, 2, 2), os.path.join(out_dir, "unused"))
    rank = dist.get_rank()
    for p, dim in zip(trainer.shards.params(), trainer.shards.param_dims()):
        if dim is None:
            p.register_hook(lambda g: g + rank * 1e-6)
    trainer.train_step((job["nafnet"]["clean"], job["nafnet"]["noisy"]))
    state, _ = trainer.state_dicts()
    return {k: v.clone() for k, v in state.items()}


def cli(out_dir, clean_dir, noisy_dir) -> dict:
    """The recipes CLI at ``--mesh 1,2,2`` with ``tp_min_size`` 64: the
    split and row-split counts of each model."""
    from midd_tpu_torch.train import recipes
    from midd_tpu_torch.train import trainer as tt

    defaults, split = recipes.default_train_config, tt.shard_rows_over_group
    counts = {}
    recipes.default_train_config = lambda model="diffusion": dataclasses.replace(defaults(model),
                                                                                   tp_min_size=tpw.TP_MIN_SIZE)

    def counted(*args, **kw):
        shards = split(*args, **kw)
        counts[current] = {"n_sharded": shards.n_sharded, "summed": len(shards.summed)}
        return shards

    tt.shard_rows_over_group = counted
    here = os.getcwd()
    try:
        for current in CLI_MODELS:
            cwd = os.path.join(out_dir, "cli", current)
            os.makedirs(cwd, exist_ok=True)
            os.chdir(cwd)
            try:
                recipes.main(dpw.cli_argv(current, clean_dir, noisy_dir) + ["--mesh", "1,2,2"])
            finally:
                os.chdir(here)
    finally:
        recipes.default_train_config, tt.shard_rows_over_group = defaults, split
    return counts


def resumed_at(job, path, mesh_shape, out_dir, tag="src") -> dict:
    """``path`` resumed at ``mesh_shape``, checked against the file, then
    trained one more epoch (its checkpoints in ``out_<tag>_<mesh_shape>``)."""
    tr = _trainer(job, mesh_shape, os.path.join(out_dir, f"out_{tag}_{mesh_shape}"), epochs=2,
                  batch=job["dataset"].shape[0])
    tr.resume(path)
    matches, epoch = dpw.restored_matches(tr, path), tr.state.epoch
    ds = spw._dataset(job)
    tr.fit(ds, [ds[0]], verbose=False)
    return {"matches": matches, "epoch": epoch, "losses": tr.state.history["losses"]}


def source_run(job, out_dir) -> dict:
    """(v)'s source: one epoch at (2, 2, 2), saved and marked ready."""
    src = _trainer(job, (2, 2, 2), os.path.join(out_dir, "src"), batch=job["dataset"].shape[0])
    ds = spw._dataset(job)
    src.fit(ds, [ds[0]], verbose=False)
    path = src.save({"tag": "src"})
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, spw.READY + ".tmp"), "w") as f:
            f.write(path)
        os.replace(os.path.join(out_dir, spw.READY + ".tmp"), os.path.join(out_dir, spw.READY))
    return {"path": path, "src_losses": src.state.history["losses"]}


def parted_resume(job, path, out_dir) -> dict:
    """The 4 ranks part into two process groups of two (a file rendezvous
    each) and resume ``path`` at (1, 1, 2) and (1, 2, 1)."""
    from midd_tpu_torch.parallel import init_distributed

    rank = dist.get_rank()
    dist.destroy_process_group()
    pair = rank // 2
    assert init_distributed(f"file://{os.path.join(out_dir, f'pair{pair}.store')}", 2, rank % 2,
                            initialization_timeout=60, backend="gloo")
    return {PAIRS[rank]: resumed_at(job, path, PAIRS[rank], out_dir)}


def main() -> None:
    from midd_tpu_torch.parallel import init_distributed

    mode, job_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    assert init_distributed(backend="gloo")
    job = torch.load(job_path, weights_only=False)
    rank = dist.get_rank()
    if mode == "sptp4":
        out = {"layers": layer_checks(13), "step": step_record(job, (1, 2, 2), out_dir),
               "drift": drift_record(job, out_dir), "diffusion": step_record(job, (1, 2, 2), out_dir, "diffusion"),
               "remat": step_record(job, (1, 2, 2), out_dir, remat=True), "cli": cli(out_dir, *sys.argv[4:6])}
        out["resume_one"] = resumed_at(job, job["one_pth"], (1, 2, 2), out_dir, tag="one")
        path = spw.wait_ready(out_dir)
        out["resume"] = {(1, 2, 2): resumed_at(job, path, (1, 2, 2), out_dir)}
        out["resume"].update(parted_resume(job, path, out_dir))
    else:
        out = {"resume_src": source_run(job, out_dir), "step": step_record(job, (2, 2, 2), out_dir)}
    torch.save(out, os.path.join(out_dir, f"{mode}.rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
