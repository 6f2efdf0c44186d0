"""One rank of the port's two-rank data-parallel checks on the CPU
(tests/test_torch_parallel.py). It imports torch and the port, never jax.

    python tests/_torch_dp_worker.py STORE RANK WORLD JOB OUT_DIR

STORE is a file for the rendezvous (``file://``), JOB a ``torch.save`` of
the inputs the test made, OUT_DIR where the rank writes ``rank<R>.pt``:
for the tiny NAFNet, expert and diffusion UNet, one dp train step from the
job's weights on this rank's rows (the loss, the parameters, the averaged
and clipped gradients, the BatchNorm buffers); a NAFNet step whose global
batch holds a NaN in rank 1's rows; the expert's state after the step
written by ``Trainer.save`` at dp 2; and a single-process ``.pth`` resumed
at dp 2, then one step from it.

    torchrun --standalone --nproc_per_node 2 tests/_torch_dp_worker.py cli OUT_DIR CLEAN NOISY

runs every recipe's CLI at ``--mesh 2,1,1`` (tiny preset, 16², one epoch)
in ``OUT_DIR/dp/<model>``, then resumes ``OUT_DIR/single/diffusion``'s
checkpoint at dp 2 for one more epoch, checking the restored state.
"""

import copy
import os
import sys

import torch

CLI_COMPARED = ("diffusion", "nafnet", "expert")  # the recipes the test also runs in one process
CLI_BATCH = {"diffusion": 2, "cddpm": 2}  # the others at their CLI batch (nafnet 2, expert 4, hybrid 6, tiny 4)


def cli_argv(model, clean_dir, noisy_dir, epochs=1):
    """The recipes CLI at the tiny preset on the CPU, 16², 8 pairs."""
    argv = ["--model", model, "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir, "--img-size", "16",
            "--epochs", str(epochs), "--max-samples", "8", "--preset", "tiny", "--device", "cpu"]
    return argv + (["--batch-size", str(CLI_BATCH[model])] if model in CLI_BATCH else [])


def restored_matches(trainer, path) -> bool:
    """Whether ``trainer`` holds exactly the state that ``path`` saved:
    weights and buffers, AdamW's state, the next epoch, best metrics and
    histories (at tp > 1 every rank must call it: the state is gathered)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    st = trainer.state
    model, opt = trainer.state_dicts()
    want = ckpt["optimizer_state_dict"]
    return (model.keys() == ckpt["model_state_dict"].keys()
            and all(torch.equal(v.cpu(), ckpt["model_state_dict"][k]) for k, v in model.items())
            and opt["param_groups"] == want["param_groups"] and opt["state"].keys() == want["state"].keys()
            and all(torch.equal(v.cpu(), want["state"][i][k]) for i, s in opt["state"].items() for k, v in s.items())
            and st.epoch == ckpt["epoch"] + 1 and (st.best_psnr, st.best_ssim) == (ckpt["best_psnr"], ckpt["best_ssim"])
            and all(st.history[k] == ckpt[k] for k in st.history))


def _tiny(name):
    from midd_tpu_torch import config
    from midd_tpu_torch.models.direct_unet import ExpertDenoiser
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
    from midd_tpu_torch.train import recipes

    return {"nafnet": lambda: EnhancedNAFNet(recipes.TINY_NAFNET),
            "expert": lambda: ExpertDenoiser(recipes.TINY_EXPERT),
            "diffusion": lambda: UNetDiffusion(config.DiffusionUNetConfig(**recipes.TINY_UNET))}[name]()


def _trainer(name, job, ckpt_dir, draw=None, mesh_shape=(2, 1, 1), remat=False, tp_min_size=1 << 16):
    """The job's trainer for ``name`` at ``mesh_shape`` (None: one process)."""
    from midd_tpu_torch import config
    from midd_tpu_torch.diffusion.schedule import make_schedule
    from midd_tpu_torch.train import trainer as tt

    cfg = tt.TrainConfig(epochs=1, batch_size=job["batch"], lr=1e-3, weight_decay=job["weight_decay"],
                         mesh_shape=mesh_shape, remat=remat, ckpt_dir=ckpt_dir, ckpt_name=name, num_workers=0,
                         prefetch=0, tp_min_size=tp_min_size)
    model = _tiny(name)
    model.load_state_dict(job[name]["state"])
    loss_fn = {"nafnet": tt.nafnet_loss_fn(), "expert": tt.expert_loss_fn(),
               "diffusion": tt.diffusion_loss_fn(make_schedule(config.SERVE_SCHEDULE))}[name]

    def fed_draw(batch, generator):  # the test's draws for the GLOBAL batch
        assert batch[0].shape[0] == job["batch"], batch[0].shape
        return draw

    return tt.Trainer(loss_fn, lambda *a: None, cfg, model, tt.no_draw if draw is None else fed_draw,
                      has_batch_stats=name == "expert", device="cpu")


def _rows(trainer, clean, noisy):
    start, n = trainer.rows
    return clean[start : start + n], noisy[start : start + n]


def _record(trainer, loss):
    model = trainer.state.model
    return {"loss": loss, "state": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}}


def cli(out_dir, clean_dir, noisy_dir) -> None:
    from midd_tpu_torch.train import recipes
    from midd_tpu_torch.train import trainer as tt

    torch.set_num_threads(1)
    for model in recipes.MODELS:
        os.makedirs(os.path.join(out_dir, "dp", model), exist_ok=True)
        os.chdir(os.path.join(out_dir, "dp", model))
        recipes.main(cli_argv(model, clean_dir, noisy_dir) + ["--mesh", "2,1,1"])
    orig = tt.Trainer.resume

    def checked_resume(self, path):
        orig(self, path)
        assert restored_matches(self, path), path
        print(f"rank {torch.distributed.get_rank()}: resumed the single-process diffusion.pth", flush=True)

    tt.Trainer.resume = checked_resume
    os.makedirs(os.path.join(out_dir, "dp_resumed"), exist_ok=True)
    os.chdir(os.path.join(out_dir, "dp_resumed"))
    st = recipes.main(cli_argv("diffusion", clean_dir, noisy_dir, epochs=2) + [
        "--mesh", "2,1,1", "--resume", os.path.join(out_dir, "single", "diffusion", "checkpoints", "diffusion.pth")])
    assert len(st.history["losses"]) == 2, st.history


def main() -> None:
    if sys.argv[1] == "cli":
        return cli(*sys.argv[2:5])
    store, rank, world, job_path, out_dir = sys.argv[1:6]
    from midd_tpu_torch.parallel import init_distributed
    from midd_tpu_torch.parallel.train_dp import dp_group

    torch.set_num_threads(1)
    assert init_distributed(f"file://{store}", int(world), int(rank), initialization_timeout=60, backend="gloo")
    job = torch.load(job_path, weights_only=True)
    out = {}
    for name in ("nafnet", "expert", "diffusion"):
        trainer = _trainer(name, job, os.path.join(out_dir, "dp_ckpt"), job[name].get("draw"))
        assert dp_group(trainer.mesh) is not None and trainer.mesh.mesh_dim_names == ("dp", "sp", "tp")
        out[name] = _record(trainer, trainer.train_step(_rows(trainer, job[name]["clean"], job[name]["noisy"])))
        out[name]["rows"] = trainer.rows
        if name == "expert":  # the state after the step, written at dp 2
            st = trainer.state
            st.best_psnr, st.best_ssim = 21.5, 0.5
            st.history["losses"].append(out[name]["loss"])
            out["saved"] = {"path": trainer.save({"note": "dp2"}),
                            "optimizer": copy.deepcopy(st.optimizer.state_dict())}

    trainer = _trainer("nafnet", job, os.path.join(out_dir, "unused"))
    out["nonfinite"] = _record(trainer, trainer.train_step(
        _rows(trainer, job["nonfinite"]["clean"], job["nafnet"]["noisy"])))
    out["nonfinite"]["optimizer_state"] = len(trainer.state.optimizer.state)

    trainer = _trainer("expert", job, os.path.join(out_dir, "unused"))
    trainer.resume(job["resume_path"])
    st = trainer.state
    out["resumed"] = {"state": {k: v.clone() for k, v in st.model.state_dict().items()},
                      "optimizer": copy.deepcopy(st.optimizer.state_dict()), "epoch": st.epoch,
                      "best": (st.best_psnr, st.best_ssim), "history": st.history}
    out["resumed"]["next_loss"] = trainer.train_step(_rows(trainer, job["expert"]["clean"], job["expert"]["noisy"]))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
