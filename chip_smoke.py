"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels from this checkout and holds each against its plain PyTorch version,
serves full-width 512² /denoise requests through the port's HTTP server,
batched at 256², adaptive and bounded at 512² and fused, runs the inference
and evaluate CLIs, runs the kernel-fused NAFNet forward, trains the full-width diffusion UNet,
NAFNet, Expert UNet, hybrid router (on the NAFNet and UNet it trained),
cddpm UNet and TinyUNet through the port's training CLI and serves the
checkpoints they wrote, and checks the card against the CPU on one exact
rollout, one ancestral cddpm rollout, one DDPM rollout of the TinyUNet, one
NAFNet forward and one training step of each model; then serves with int8
convolutions (``--int8``) and at the 1024² operating point through the
server, runs the MODEL2_NAFNET variant, runs the xraybench-v1 quality
benchmark (train, score, variants, turbo gate, seed study) at serve widths,
trains with rematerialisation, serves tensor- and data-parallel (the
engine's ``--tp`` / ``--dp``) on the one card, trains data, tensor and
spatial parallel (dp 2, tp 2, dp 2 x tp 2, sp 2, dp 2 x sp 2, sp 2 x tp
2, dp 2 x sp 2 x tp 2) over ranks,
serves int8 under tp, serves spatial-parallel (``--sp``, with dp, tp
and int8), and counts FLOPs on the card, runs the training benchmark
(``bench_train_torch.py --quick``) and the native data path, and serves
from AOT-pinned programs (``--aot``), compiled beside the other phases.

    python3 chip_smoke.py [--report FILE] [--naf-only]

The default run takes 14 to 18 minutes on one NVIDIA H100 80GB HBM3 at
700 W (834 to 1068 s of script, the kernels' build 56 to 80 s of it, the
host's speed moving the rest), within its 1200 s limit. Phase 22b is not
part of it: it runs with ``--aot-int8-only``.

Phases (any failure exits non-zero, and no result line is printed):
1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/ln2d.cu and
   csrc/naf_ffn.cu with nvcc, all four at once;
3. forward kernel vs plain: flash_attention (tensor cores: bf16 in one
   pass, fp32 in three TF32 passes) against flash_attention_plain (TF32
   off) at the served shapes, the hybrid trainer's rollout shape (12, 4096,
   96) in fp32, and a few others; timed at the three served sequence
   lengths (N 1024, 4096, 16384; D 96; bf16) and at the training shapes
   (2 and 12, 4096, 96) in fp32, at a bucket-8 batch at 256² (16, 1024,
   96) in both dtypes and at the wide UNet's heads of 192 (a scored batch
   (8, 1024, 192) bf16, a training step (4, 1024, 192) fp32), each call
   alone (``ms``) and 5 in a row
   (``ms_batched``), each beside SDPA timed the same two ways in the same
   dtype and the bound (operations over the bf16 or the TF32 peak);
4. backward kernels vs plain: flash_bwd_dq and flash_bwd_dkv against their
   plain versions (TF32 off), timed as in phase 3 at the same shapes
   beside SDPA's backward in the same dtype (its device time under the
   profiler) and their bounds;
5. ln2d kernel vs plain at every SERVE_NAFNET stage shape of a 512² input
   (batch 1 and 2, fp32 and bf16; the hybrid trainer's batch 6, fp32, in
   both layouts), at every stage of a bucket-8 batch at 256² (fp32 and
   bf16, untimed) in each layout the engine feeds it there (found by
   running the NAFNet on such a batch: cuDNN picks each convolution's
   output layout), and one ragged shape, fp32 and bf16, with timings (as in
   phase 3, and one call's device time under the profiler) and
   ``F.layer_norm`` on a channels-last copy as yardstick, and
   untimed at the channels-last kernel's edges (small P, C 1 and 7, a view
   off 16-byte alignment); fp32 must equal the plain version bit for bit
   at every C;
6. naf_ffn kernel (tensor cores: bf16 in one pass, fp32 in three TF32
   passes) vs plain at the same shapes, fp32 and bf16, with timings (as in
   phase 5) and the bound at the tensor cores' rates;
7. fused NAFNet forward: ``nafnet_apply_fused`` at SERVE_NAFNET, 512², fp32,
   against the module's forward (TF32 off); exactly 30 naf_ffn launches;
8. serving slice: InferenceEngine(EngineConfig()) at 512² with seeded demo
   weights behind the stdlib server; 3 multipart requests, four non-null
   PNGs each, exactly 48 flash forward, 120 ln2d (the nafnet path and the
   hybrid's NAFNet backend) and no backward launches per request;
8b. batched, adaptive and fused serving and the CLIs, each engine at the
   SERVE_* presets with seeded demo weights behind the stdlib server,
   distinct PNGs: (a) 256², batching, auto buckets (1, 2, 4, 8): 8 clients
   x 2 requests, four PNGs each, fewer batches than requests, one of more
   than 1, exactly 48 flash forward and 120 ln2d launches a batch; then an
   exact fp32 engine's one bucket-8 batch of 8 images against each served
   alone (1e-4); (b) 512², buckets (1,), adaptive turbo from a queue of 3,
   at most 6 waiting: 12 clients at once, every refusal a 503 with
   Retry-After and counted in the batcher's ``rejected``, turbo and exact
   batches both run, 48 flash forward launches an exact batch and 36 a
   turbo one ((0, 2, 7) on both rollouts), fused requests on (no fused
   failure; nothing shared with demo weights); (c) 512², fused requests on a
   router+fusion-only hybrid.pth (backends and rollout shared): 24 flash
   forward and 60 ln2d launches a request, no fused failure, fused equal to
   per-path (1e-6), ``GET /ui`` a page; (d) ``inference.main`` --model
   nafnet --tta on a 512² PNG (240 ln2d launches) and ``evaluate.main``
   --model hybrid over 4 seeded 512² pairs (reference-exact: 216 flash
   forward and 240 ln2d launches; finite PSNR and SSIM);
9. card vs CPU: one exact fp32 diffusion rollout and one fp32 NAFNet forward
   at 256² on both devices, one CDDPM_UNET ancestral rollout at 256² (8
   inference steps, 9 scan steps of 4 flash forward launches, no eps clamp)
   and one 12-step DDPMScheduler rollout of TINY_UNET at 256², each on one
   shared ``noise_seq``;
10. one training step, card vs CPU, of each model at 128², fp32, TF32 off,
   same weights and batch: SERVE_DIFFUSION (6 forward, 6 dq and 6 dk/dv
   launches), SERVE_NAFNET (60 ln2d launches; every LayerNorm2d weight
   and bias gets a gradient), SERVE_EXPERT at batch 2 (train-mode
   BatchNorm; both running buffers of every BatchNorm compared too) and
   the HybridConfig() router and fusion at batch 2 on seeded frozen
   backends (60 ln2d and 6 x 10 flash forward launches, none backward),
   CDDPM_UNET at batch 1 (4 forward, 4 dq and 4 dk/dv launches) and
   TINY_UNET at batch 2 (no port kernel); loss and every trained
   parameter's gradient compared;
11. training slices: ``recipes.main`` --model diffusion (512², 1 epoch, 4
   seeded synthetic pairs, batch 1 = 4 train steps of 6/6/6 launches and a
   validation rollout of 17 evals), --model nafnet (512², 1 epoch, 8
   pairs, batch 2 = 4 train steps of 60 ln2d launches and one validation
   forward), --model expert (16 pairs, batch 4 = 4 train steps and one
   validation forward, no port kernel) and --model hybrid (12 pairs, batch
   6 = 2 train steps of 60 ln2d and 60 flash forward launches and 5
   validation forwards, on the .pth files of the diffusion and nafnet
   runs), --model cddpm (4 pairs, batch 1 = 4 train steps of 4/4/4
   launches and an ancestral validation rollout of 17 evals of 4 flash
   forwards) and --model tiny (8 pairs, batch 4 = 2 train steps and one
   12-step DDPM validation rollout, no port kernel); finite losses, moved
   parameters (and, for the expert, moved running statistics), a .pth with
   its metadata (the hybrid's with only router and fusion weights, the
   cddpm's with ``skip_mode``); then an InferenceEngine on each checkpoint
   answers one 512² request (the hybrid's beside its two backends, the
   cddpm's served as the diffusion model: 32 flash forward launches), and a
   TinyUNetDenoiser on the tiny checkpoint denoises one PNG at 256²;
12. int8: (a) the card's int32 product (``torch._int_mm``) against its
   plain version (float64 products on the card) bit for bit at every int8
   conv shape of SERVE_DIFFUSION at 512², batch 1 and 2, timed at batch 1
   beside cuDNN's bf16 and fp32 convolutions of the same shapes; (b) the
   server's ``--int8`` configuration (static scales calibrated at startup,
   its time logged) at 512²: 3 requests, four PNGs each, 48 flash forward
   and 120 ln2d launches and 8 UNet evals' int8 products a request; the
   rollout paths' wall, device time and peak memory against a default
   engine's, and max|int8 - fp32| per path as information; (c) card vs CPU,
   fp32 with TF32 off, same seeded weights: the calibration at 128² on the
   first noise family's batch (``INT8_ABSMAX_REL``) and, on the CPU's
   scales, one int8 UNet eval and one 128² int8 rollout, each against twice
   the CPU's own spread when its attention sums in another order (``INT8_SPREAD_RATIO``), the rollout
   also to ``INT8_ROLLOUT_MAX`` and ``INT8_ROLLOUT_CORR``;
13. 1024² at full width: the server's ``--img-size 1024`` configuration, 3
   requests of other sizes, 48 flash forward (N 16384) and 120 ln2d launches
   each, every path's wall, device time and peak memory; two fp32-eval
   engines with TF32 off, ``use_flash_attention`` True and False, on one
   image: the exact path launches no flash kernel and agrees with flash to
   ``EXACT_VS_FLASH_BOUND`` on the two rollout paths, both timed;
14. MODEL2_NAFNET: ln2d and naf_ffn against their plain versions at each of
   its stages of a 512² input (C 24 to 384), fp32 and bf16, both layouts
   (fp32 ln2d bit for bit); the module at 512² card vs CPU (1e-4 of
   max|out|); ``nafnet_apply_fused`` against the module on the card, one
   naf_ffn launch per NAFBlock (23);
15. xraybench-v1 (``midd_tpu_torch.benchmarks.xray_bench``'s CLI, in this
   process) at serve widths, 256², the tpu hybrid profile, 8 training
   phantoms, every recipe at its 2-epoch floor, one eval image a noise
   family: (a) ``--train`` and
   ``--train-wide --train-ddim50`` into one directory, every run marked
   finished; (b) the score: the rows of ``XB_ROWS``, each finite (a PSNR of
   None only for an exact reconstruction), the JAX CLI's payload keys, the
   ``_input`` row equal to the CPU's to 1e-5, and per scored batch exactly
   54 flash forward launches a 9-step rollout (300 at 50 steps) and 60 ln2d
   a NAFNet; (c) card against CPU on the trained nafnet and hybrid (whose
   rollout is the diffusion row's UNet) on the eval set's first image,
   TF32 off (``XB_PSNR_*``,
   ``XB_SSIM_*``); (d) ``--turbo-gate`` (k = 1 launches as exact, k = 2, 3
   fewer); (e) ``--seeds 1 --seed-models diffusion`` twice, the second
   reusing the marked run and training nothing. Each step's wall is printed
   (``utils.profiling.Timer``), and the CLI's own per-row walls;
16. rematerialisation at 512², fp32 with TF32 off: ``TrainConfig(remat=True)``
   against the plain step from the same weights and draws, SERVE_DIFFUSION
   at batch 1 (12 flash forward launches a step against 6: the backward
   recomputes the whole loss; 6 dq and 6 dk/dv) and SERVE_EXPERT at batch 4
   (BatchNorm buffers bit for bit, moved once), loss, gradients and weights
   to ``REMAT_*``, each step's wall and the peak memory;
17. tensor- and data-parallel serving on the one card
   (``devices=["cuda:0"] * 2``), SERVE_* widths, 512², TF32 off, seeded
   demo weights: (a) tp 2 against the unsharded engine (fp32 evals, fused
   requests and the turbo tier on): ``n_tp_sharded`` equal to the JAX
   engine's count (``TP2_SERVE_SHARDED``), 48 flash forward and 120 ln2d
   launches a request (fused and per path), the four paths', the fused and
   the turbo functions' outputs to ``TP_FP32_BOUND``, each path's wall and
   device time beside the unsharded engine's (not a speed result: both
   slices share the card); (b) dp 2 with batching, buckets (1, 2) -> (2,):
   3 requests through the server, one 2-row batch each of 96 flash forward
   and 240 ln2d launches, and a 2-row batch against each image served alone
   (``DP_VS_ONE_BOUND``); (c) the default engine (bf16 UNet evals) at tp 2
   against unsharded (``TP_BF16_BOUND`` on the rollout paths), its conv
   slices in bf16;
18. training under ``python -m torch.distributed.run`` on the one card
   (this script's ``--dp-rank`` mode; gloo, the ranks share the card),
   512², TF32 off, seeded weights, in two launches that run at once (after
   phase 21's 8-rank launch), each
   run against the same CLI in this process: 4 ranks, the recipes CLI at
   ``--mesh 2,1,2`` (18b) and ``--mesh 2,2,1`` (19b), SERVE_NAFNET at batch 2
   for 2 steps; 2 ranks, ``--mesh 2,1,1`` (16b) for diffusion (batch 2),
   nafnet (2) and expert (4), 4 steps each, ``--mesh 1,1,2`` (18a) and
   ``--mesh 1,2,1`` (19b) for SERVE_DIFFUSION at batch 1 for 3 steps, the
   one-process diffusion ``.pth`` resumed at dp 2 (16c) and, once the 4-rank
   launch has ended, its two NAFNet ``.pth`` files resumed at tp 2 and at
   sp 2; every parallel ``.pth`` also resumed in this process. Every rank's
   launches a step (6/6/6 flash, 60 ln2d), split count (tp: the JAX
   trainer's, ``TP2_TRAIN_SHARDED``) and row-split parameters (sp: every
   convolution's but SCA's), equal losses on every rank, losses and
   ``.pth`` weights to ``DP_*``, the expert's buffers to ``DP_STATS_REL``,
   the ``.pth`` in the single-process layout, every resume equal to its
   file as it loads (a resumed run trains one step of its second epoch),
   the step walls (a correctness run, not a speed result); and (18c), once
   the 4-rank launch has ended, beside the 2-rank one's last runs, the
   server's ``--int8 --tp`` (static int8, phase 12's scales) at tp 2
   against the unsharded static-int8 engine on the same scales, fp32
   evals, fused and turbo on: ``n_tp_sharded``, 48 flash forward and 120
   ln2d launches a request, every path's, the fused and the turbo
   functions' outputs to ``INT8_TP_BOUND``;
19. spatial-parallel serving on the one card, 512², TF32 off, seeded demo
   weights, against phases 17 and 18c's unsharded engines: sp 2 (fp32
   evals, fused and turbo on; 48 flash and 120 ln2d launches a request,
   as unsharded; every path, the fused and the turbo functions to
   ``SP_FP32_BOUND``; each path's wall and device time beside unsharded,
   not a speed result), sp 2 × tp 2 (``n_tp_sharded`` the JAX count) and
   dp 2 × sp 2 on 4 slots of the card (fp32, ``SP_FP32_BOUND``), the
   server's ``--sp 2`` configuration answering a request through the
   server (bf16 evals, ``TP_BF16_BOUND`` on the rollout paths), ``--int8``
   at sp 2 on the unsharded int8 engine's scales (``INT8_TP_BOUND``), and
   ``sp_size=64`` at 512² refused with the JAX engine's message;
20. the FLOP counter (``utils/flops.py``) on the card in bf16 at 256², the
   plain layout with the exact attention: the UNet and NAFNet forwards
   (batch 1), bench.py's DDIM-50 rollout and one training step of each
   (batch 2, the trainer's loss forward and backward: the bench's own
   counts) equal to the JAX package's (``FLOPS_*``); ``device_peak_tflops()`` 989 beside the
   card's name and power limit; ``bench_train_torch.py --quick`` in this
   process, its JSON line printed (finite step times, 0 < MFU <= 1, its
   counts the constants), its flash forward, dq, dk/dv and ln2d launches
   held to ``BENCH_LAUNCHES``; the native data path built with this
   machine's g++, a seeded 2048² uint8 image resized to 512² within
   ``NATIVE_PIL_LSB`` of PIL (both timed), and ``PairedXRayDataset`` over
   16 seeded 1024² pairs at 256² on the loader's two threads with
   ``MIDD_TPU_NATIVE`` 0 and 1, timed, within the same bound;
21. (inside phase 18's launches) training at sp and tp together, 512²,
   TF32 off, gloo, seeded weights, the ranks sharing the card: (a) the
   recipes CLI at ``--mesh 1,2,2``, SERVE_DIFFUSION at batch 1 for 3 steps
   on tp's pairs, a run of the 4-rank launch; (b) ``--mesh 2,2,2``,
   SERVE_NAFNET at batch 2 for 2 steps, in an 8-rank launch that runs
   before the 4- and 2-rank ones; each against phase 18's one-process run
   on the same pairs (``DP_*``), every rank's launches a step (6/6/6 flash, 60
   ln2d), tp split count (``TP2_TRAIN_SHARDED``), row-split parameters
   (every convolution's but SCA's) and losses equal on every rank, the
   ``.pth`` in the single-process layout, and (b)'s ``.pth`` resumed
   exactly in this process and at ``--mesh 2,1,2`` in the 4-rank launch;
   the step walls beside the card's name and power limit (a correctness
   run, not a speed result);
22. AOT-pinned serving at 512², SERVE widths (``EngineConfig(aot_dir=D,
   cache_dir=C)``, ``utils/compile_cache.py``): the cold start, in a process
   of its own (``--aot-cold``) that starts after phase 2 and compiles beside
   phases 3-21, pins every path at bucket 1 into empty D and C and serves 3
   seeded requests; then a second start loads every pin, and with TF32 off
   the two pinned engines agree bit for bit, nafnet and expert within 1e-4
   and the bf16-eval rollouts within 5e-2 of the eager engine, each pinned
   request makes 48 flash and 120 ln2d launches (the kernels run inside
   the programs as custom ops) and no pin is dropped; ``python -m
   midd_tpu_torch.serve.server --aot D`` in a new process loads every pin
   (its ``aot_load`` events, no ``aot_compile``) and answers a request.
   Each start's time to ready, each path's wall, device ms and launches,
   pinned beside eager, and ``flash_host_us`` (the custom op's dispatch
   beside the direct call) are printed: facts, not gates.
   The same cold process then pins one static ``QuantConv2d`` at a SERVE
   int8 shape (``AOT_QCONV``) with the card's int8 product
   (``torch._int_mm``): loaded here, it equals eager bit for bit at two
   scales passed through the state (inputs and weights on their exact int8
   grids), with as many int8 GEMM kernels as eager by the profiler's names.
22b. (``--aot-int8-only``, not in the default run: its cold start, 1459 to
   1974 s alone on the card's host for 12 programs, and past the limit for
   6 beside phases 3-21, does not fit the script's 1200 s; ROADMAP queue 1
   item 16c stays open until it does.) The pinned ``--img-size 256 --int8
   --batching --buckets 1,2 --adaptive --aot D`` server (``AOT_INT8_ARGS``):
   its cold start, in a niced process, compiles the 12 programs (the four paths
   and the two turbo paths at batches 1 and 2) into an empty D; each pin's
   export and compile seconds, Inductor's timers, its worker's peak card
   memory and the host's cores are printed. Then the server starts on D in
   a new process (an ``aot_load`` event a pin, no ``aot_compile``) while a
   second start here loads every pin and an eager engine of the same
   configuration sits beside it, TF32 off: their calibrated scales within
   ``INT8_ABSMAX_REL``; each program called on a seeded 256² batch of 2
   against eager (nafnet and expert within 1e-4, the int8 rollouts within
   phase 12's rollout gates) and against each of its rows alone (the batch-1
   pins); a pinned batch makes 48 flash and 120 ln2d launches and a turbo
   batch 36 and 120, as eager, and as many int8 GEMM kernels as eager's (by
   the profiler's kernel names: the launch counters cannot see inside a
   program); no pin dropped. The server then answers 12 closed-loop clients
   × 2 requests with a mean batch above 1, turbo batches, no pin dropped and
   its batch-2 exact and turbo programs serving (``/health``'s ``batching``
   and ``aot`` counts). Each program's wall, device ms and idle share,
   pinned beside eager, are printed last.
The CPU halves of phases 9, 10 and 12c's calibration run on another thread
while the kernels build (phase 2): the same functions on the same seeded
inputs (``on_devices``).
Where ``torch.profiler`` records no device kernel three times running, it
is off for the rest of the run and device times are taken by CUDA events
behind a sleep kernel instead (``device_ms_events``). A profile that holds
fewer of a port kernel's runs than its counter saw launched, or whose
device sum is under half the call's time by those events, is partial: it
is taken again, up to 3 times, and then that call alone is timed by the
events. The ``total_s`` line counts both under ``profiler``.
The second-to-last line is the kernels JSON (each flash entry with an
``fp32`` object and the times of every timed shape), the last
{"ok": true, ...}.

``--dp-rank JOB`` is phase 18's rank mode (run by torchrun, not by hand);
``--aot-cold DIR [--aot-configs default,qconv|int8]`` is phases 22 and
22b's cold starts (run by the script). ``--aot-int8-only`` runs phases 1,
2 (the flash forward and ln2d) and 22b alone and prints no result line.
``--naf-only`` runs phases 1, 2 (ln2d and naf_ffn), 6 and 7 (with
phase 7's profile) and prints the kernels line without a result line: an
A/B of the NAFNet kernels, each tree's own package beside this script.

``--report FILE`` also measures where a request's and a training step's time
goes and writes a longer JSON report to FILE: every request and path time, 6
more HTTP requests and 6 in-process ``process_all`` calls, each path's wall
time (median of 5) beside its device time under ``torch.profiler`` (by kernel
kind, top kernels, idle share = 1 - device / wall), ``F.group_norm`` against
the port's ``GroupNorm32`` at the largest GroupNorm input of a 512² UNet
eval, the host time per serving call of the flash forward through its
autograd Function against a direct call, the device time by kernel kind of
one ``nafnet_apply_fused`` call and one module forward at 512², the sums
over one NAFNet forward of the ln2d and naf_ffn per-call times of phases 5
and 6 (computed from isolated calls, not measured in a forward), and the
same wall/device breakdown and the peak memory for one 512² training step
of each model (diffusion, NAFNet, expert, hybrid, cddpm, tiny) at its CLI
batch, and for one ``bench_train_torch.py --quick`` step of each of its
models (bf16, 256², batch 2); and, for batched serving, request rate and wall p50 / p95 under 8
closed-loop clients of 4 requests each, at 256² with buckets (1,) against
(1, 2, 4, 8) and at 512² with (1,) against (1, 2), in turns (A, B, B, A),
and one fused 512² request's wall and device time against the per-path
request's.
"""

from __future__ import annotations

import atexit
import base64
import contextlib
import copy
import dataclasses
import gc
import http.client
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

import bench_train_torch
from midd_tpu_torch import config, evaluate, inference, native
from midd_tpu_torch.benchmarks import xray_bench
from midd_tpu_torch.diffusion.ddpm_scheduler import DDPMScheduler, TinyUNetDenoiser
from midd_tpu_torch.diffusion.sampler import denoise
from midd_tpu_torch.diffusion.schedule import make_schedule, timestep_sequence
from midd_tpu_torch.models.blocks import AttentionBlock, BatchNorm2d, GroupNorm32, LayerNorm2d, init_weights
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import RouterFusion
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.tiny_unet import TinyUNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops import _build
from midd_tpu_torch.ops import flash_attention as fa
from midd_tpu_torch.ops import ln2d as ln
from midd_tpu_torch.ops import naf_ffn as ffn
from midd_tpu_torch.ops import qconv
from midd_tpu_torch.ops.naf_fast import nafnet_apply_fused
from midd_tpu_torch.parallel import ColumnParallel, RowParallel
from midd_tpu_torch.serve import engine as engine_module
from midd_tpu_torch.serve import server
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine, calibration_batches
from midd_tpu_torch.serve.server import make_server
from midd_tpu_torch.train import recipes
from midd_tpu_torch.train.data import PairedXRayDataset, batches, to_device
from midd_tpu_torch.train.trainer import (Trainer, cddpm_loss_fn, diffusion_draw, diffusion_loss_fn,
                                          expert_loss_fn, hybrid_loss_fn, nafnet_loss_fn, no_draw,
                                          tiny_draw, tiny_loss_fn)
from midd_tpu_torch.utils import flops
from midd_tpu_torch.utils.compile_cache import load_executable, pin_or_load, pin_workers
from midd_tpu_torch.utils.profiling import Timer

# H100 SXM data sheet (dense): bf16 and TF32 tensor-core peaks, fp32
# CUDA-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# (bh, n, d, dtype). The plain version runs in fp32 on the same (for bf16:
# bf16-rounded) inputs, with TF32 off.
# Each flash kernel and SDPA's forward (and in phase 5 ln2d and
# F.layer_norm) is timed twice: "ms" with events around each call alone, as
# every kernel of the kernels line (the host's launch of the call is inside),
# and "ms_batched" over 5 calls in a row, divided by 5.
FLASH_BATCH = 5
TIMED_D = (96, 192)  # head dims of the served UNet and of the wide one
MAIN = (2, 4096, 96, torch.bfloat16)
CASES = [
    MAIN,
    (2, 4096, 96, torch.float32),
    (12, 4096, 96, torch.float32),  # the hybrid trainer's rollout: batch 6 x 2 heads at 512²
    (2, 1024, 96, torch.bfloat16),
    (2, 16384, 96, torch.bfloat16),
    # a bucket-8 batch at 256² (phase 8b): 8 images x 2 heads in one launch
    (16, 1024, 96, torch.bfloat16),
    (16, 1024, 96, torch.float32),
    # the wide UNet (WIDE_DIFFUSION, heads of 192; phase 15): a scored batch of
    # 4 images at 256² (bf16 evals), a training step of 2 (fp32)
    (8, 1024, 192, torch.bfloat16),
    (4, 1024, 192, torch.float32),
    (2, 1000, 64, torch.float32),
    (2, 1000, 64, torch.bfloat16),
    (2, 64, 8, torch.float32),
]
# lse is computed from fp32 scores on both sides, in another summation order
# (measured <= 2e-6 on the H100); so is O in fp32 (measured <= 6e-7).
TOL_FP32 = 1e-5
# bf16 O: the kernel rounds p to bf16 before p.v (relative error <= 2^-9 per
# term, random in sign) and O to bf16 on output (<= 2^-9 of |O|). Two bf16
# ulps of the largest output, 2^-7 * max|O|, holds both (measured at a third
# to a half of it); an absolute bound would have to be sized for |O| near 1,
# while these outputs are 0.01-0.3.
BF16_O_REL = 2.0 ** -7
PROFILE_REQUESTS = 6
PER_REQUEST = {
    "flash_fwd": 48,  # (4 diffusion + 4 hybrid UNet evals) x 6 attention blocks
    "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "ln2d": 120,  # (nafnet path + the hybrid's NAFNet backend) x 30 NAFBlocks x 2 norms
    "naf_ffn": 0,  # no engine path runs the fused functional forward
}
# A request to an engine whose diffusion checkpoint is the cddpm UNet (phase
# 11e): 4 AttentionBlocks an eval (2 down, 1 mid, 1 up) in place of 6, in the
# diffusion path's 4 evals and in the hybrid's 4, whose seeded UNet takes the
# served diffusion architecture when there is no hybrid checkpoint.
CDDPM_PER_REQUEST = {**PER_REQUEST, "flash_fwd": 32}
CARD_VS_CPU_BOUND = 1e-3

# SERVE_NAFNET at 512²: (C, H = W) of each stage, and the LayerNorm2d calls
# (2 per NAFBlock) and FFN halves (1 per NAFBlock) one forward makes there:
# encoders (2, 2, 4, 6) at C 32..256, 8 middle blocks at C 512, decoders
# (2, 2, 2, 2) at C 256..32.
NAF_STAGES = [(32, 512), (64, 256), (128, 128), (256, 64), (512, 32)]
NAF_BLOCKS = {32: 4, 64: 4, 128: 6, 256: 8, 512: 8}
NAF_RAGGED = (48, 37, 29)  # (C, H, W): C not a multiple of 32, odd H*W
# the largest auto bucket at 256² (phase 8b): its NAFNet stages at batch 8
SERVE_BUCKET = 8
NAF_STAGES_256 = [(c, s // 2) for c, s in NAF_STAGES]
# (b, c, h, w, dtype, layout): the staged channels-last kernel at its edges,
# checked and not timed: small P (C 512 at 4x4: one and two blocks of 8
# pixels), C 1 and C 7 (bf16: C * 2 not a multiple of 16, so scalar loads),
# and a view one element into its storage (scalar loads)
LN_EDGE_CASES = [
    (1, 512, 4, 4, torch.float32, "channels_last"), (2, 512, 4, 4, torch.float32, "channels_last"),
    (2, 512, 4, 4, torch.bfloat16, "channels_last"),
    (2, 1, 9, 7, torch.float32, "channels_last"), (2, 7, 9, 7, torch.float32, "channels_last"),
    (2, 7, 9, 7, torch.bfloat16, "channels_last"),
    (2, 64, 9, 7, torch.float32, "channels_last_offset"),
    (2, 64, 9, 7, torch.bfloat16, "channels_last_offset"),
]
# ln2d fp32: the kernel takes its sums in the plain version's order with
# every step rounded as written and divides by C, as the plain version does
# (it divides by a tensor: PyTorch's CUDA division by a Python int would be a
# product with 1/C, off in the last bit where C is not a power of 2). So the
# two agree to the last bit at every C, which phase 5 requires.
# 1e-5 of max|y| alone would still hold a summation in another order
# (about sqrt(C) ulps of E[x^2], amplified by mean^2 / var ~ 7 at these
# inputs, whose mean is 2.5x their spread), while a fault of one term in
# 10^4 would not fit.
LN_FP32_REL = 1e-5
# bf16: both sides compute in fp32 from the same bf16 inputs and round once
# to bf16; where the fp32 values straddle a rounding boundary they differ by
# one bf16 ulp: two ulps of the largest output, 2^-7 * max|y|, as for the
# flash kernels.
LN_BF16_REL = 2.0 ** -7
# naf_ffn fp32: the two products sum C (then C) terms in another order than
# cuBLAS (TF32 off), each term from three TF32 passes (21 of fp32's 24 bits
# of each operand, the low part truncated by the tensor cores): ~sqrt(C) *
# 2^-21 of the terms' size, ~1e-6 of max|out| at C 512; 1e-5 leaves a margin
# while a one-pass TF32 product (2^-11) would not fit. bf16: the kernel
# rounds xn, the gate g and the conv weights to bf16 before its products
# (the TPU's default-precision dot does the same), the plain version keeps
# them in fp32. Each rounding is 2^-9 relative and
# random in sign, so the residual branch (W5 g + b5) * gamma is off by ~2^-8
# of its own size, which is a fraction of |x| here (gamma ~ 0.2): under a
# tenth of a bf16 ulp of out. Out is then rounded to bf16 on both sides, so
# they differ by at most one ulp of |out| where the fp32 values straddle a
# rounding boundary: within two ulps of the largest output, 2^-7 * max|out|,
# as for ln2d.
FFN_FP32_REL = 1e-5
FFN_BF16_REL = 2.0 ** -7
# nafnet_apply_fused vs the module, fp32, TF32 off: the same convolutions;
# norm1 and norm2 take a centred variance in the fused forward and the
# one-pass one in the module (both in fp32, ~1e-7 relative apart at these
# activations), and the FFN products sum in another order, through 30
# blocks. 1e-4 of max|out|: a TF32 layer (2^-11) would not fit.
NAFNET_FUSED_REL = 1e-4
# One NAFNet forward at 256², card vs CPU, fp32, TF32 off: the convolutions
# in another order (~1e-6 relative per layer, through ~170 layers); the
# same bound, for the same reason.
NAFNET_CARD_VS_CPU_REL = 1e-4

# Backward cases: the training shape first (fp32, as the trainer runs), then
# as the forward's cases. dO is drawn like q, k, v (non-uniform).
BWD_CASES = [
    (2, 4096, 96, torch.float32),
    MAIN,
    (4, 1024, 192, torch.float32),  # the wide UNet's training step (phase 15)
    (8, 1024, 192, torch.bfloat16),
    (2, 1024, 96, torch.bfloat16),
    (2, 16384, 96, torch.bfloat16),
    (2, 1000, 64, torch.float32),
    (2, 1000, 64, torch.bfloat16),
    (2, 64, 8, torch.float32),
]
# fp32 dX: both sides compute in fp32 from the same inputs and differ only in
# summation order and exp2f against exp (a few ulps per term), so 1e-5 of
# max|dX| leaves a margin of ~10x over what they can differ by (measured
# <= 9.1e-7 of max|dX| on the H100).
BWD_FP32_REL = 1e-5
# bf16 dX: both sides round ds and p^T to bf16 at the same points; they
# differ where an fp32 value sits on a rounding boundary (one bf16 ulp of one
# term of a long sum) and in the final rounding of dX to bf16 (one ulp of
# |dX|). Two bf16 ulps of the largest gradient, 2^-7 * max|dX|, holds both,
# as for the forward's O.
BWD_BF16_REL = 2.0 ** -7
# One training step at 128², fp32 with TF32 off on both devices: convolution
# and matmul sums in another order (~1e-6 relative per op) through ~80
# layers, plus rare flips at the loss's non-smooth points (the eps and x0
# clamps, the L1 sign), each of which moves one pixel's cotangent. Each
# parameter's gradient must agree to 1e-4 of its largest entry (measured
# 3.6-4.0e-6 on the H100, so ~25x of margin, while a layer run at reduced
# precision, TF32 at 2^-11, would not fit under it); that entry is floored
# at 1e-3 of the largest gradient of the model, because the key biases of
# the qkv convs have an exactly zero gradient in exact arithmetic (softmax
# is invariant to a constant shift of every key) and both devices then
# return rounding noise. The losses must agree to 1e-5 relative.
STEP_GRAD_REL = 1e-4
STEP_LOSS_REL = 1e-5
# The expert step's BatchNorm running buffers, card vs CPU: means and biased
# variances of the batch in fp32, each a sum in another order (~sqrt(n)
# 2^-24 relative, n = 2 x 128² values a channel at the first layers), moved
# a tenth of the way from (0, 1): 1e-5 of each buffer's largest entry.
STEP_STATS_REL = 1e-5
# The expert step's gradients are not held to STEP_GRAD_REL: through 13
# train-mode BatchNorms whose one-pass variance E[x²] − E[x]² (flax's, and
# so the port's) is differentiated as written, the two terms of its gradient
# cancel, and rounding is amplified ~10^4-fold. On the CPU alone, weights
# moved up by one ulp move a gradient by up to ~3e-2 of its largest entry
# and by ~4e-3 of its norm in L2 (``cpu_one_ulp`` of phase 10c, measured in
# every run). Each gradient is held instead to 2e-2 of its norm in L2: ~5x
# that one-ulp spread, while weights cut to TF32's 10 mantissa bits move
# them by ~0.1 of their norm (``cpu_tf32_weights``, which must fail it).
EXPERT_GRAD_REL_L2 = 2e-2
TRAIN_SIZE = 512
TRAIN_PAIRS = 4
VAL_EVALS = 17  # val_inference_steps 15 over 50 noise steps: stride 3, t = 48..0
NAF_TRAIN_PAIRS = 8  # 4 steps at the CLI's batch of 2
EXPERT_TRAIN_PAIRS = 16  # 4 steps at the CLI's batch of 4
HYBRID_BATCH = 6  # the hybrid CLI's batch
HYBRID_TRAIN_PAIRS = 12  # 2 steps at the CLI's batch of 6
HYBRID_VAL_SAMPLES = 5  # the hybrid recipe validates on 5 samples
CDDPM_ATTENTION = 4  # AttentionBlocks per CDDPM_UNET eval: 2 down, 1 mid, 1 up
TINY_BATCH = 4  # the tiny CLI's batch
TINY_TRAIN_PAIRS = 8  # 2 steps at the CLI's batch of 4
TINY_STEPS = 12  # the DDPMScheduler rollout of the tiny recipe and its denoiser
NO_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "ln2d": 0, "naf_ffn": 0}
BATCH_CLIENTS, BATCH_REQUESTS = 8, 2  # phase 8b (a): 8 clients, 2 requests each
ADAPTIVE_CLIENTS, ADAPTIVE_MAX_QUEUE = 12, 6  # phase 8b (b)
FUSED_REQUESTS = 3  # phase 8b (c)
CLI_PAIRS = 4  # phase 8b (d)
REPORT_CLIENTS, REPORT_REQUESTS = 8, 4  # --report: 8 clients, 4 requests each
# A bucket-8 batch against each of its images served alone, exact fp32 with
# TF32 off: the same layers, but cuDNN may pick another algorithm for
# another batch, so convolution sums run in another order (~1e-6 relative
# per layer) through the 9-step rollouts; the card-vs-CPU rollout of phase 9
# reads ~1e-6 under the same conditions. 1e-4 leaves a margin while a path
# run at reduced precision (TF32 at 2^-11) would not fit.
BATCH_VS_SINGLE_BOUND = 1e-4
# fused against per-path: the same modules on the same inputs, on one
# thread, so the same kernels in the same order; only a computation that
# differs (another eval precision or schedule) would show.
FUSED_BOUND = 1e-6
# int8 (phase 12). The card's int32 product (torch._int_mm) and the plain one
# (float64 products, exact) sum the same integers: bit for bit. Calibration,
# card vs CPU, same weights and images, fp32 with TF32 off: each act_absmax is
# one activation's magnitude after up to ~40 layers summed in another order
# (~1e-6 relative; the card-vs-CPU rollout of phase 9a reads ~1e-6), so 1e-4
# relative, while a layer at TF32 (2^-11) would not fit.
INT8_ABSMAX_REL = 1e-4
# An int8 eval and rollout, card vs CPU on the same scales: the fp32 sums
# differ in the last bits, an activation on a rounding boundary of its int8
# grid then moves by a whole step, and that reaches every later layer. The
# CPU alone moves as far when only its attention's summation order changes
# (the flash kernel's plain version in place of the reference: the
# ``cpu_spread``). On the H100 at 256², full width, seeded weights (my chip
# run, PR 12, call 2): one eval max 0.198 of |eps| <= 2.2, the CPU's own
# 0.166 (this sandbox's CPU); the rollout max 0.046, mean 4.2e-3, corr
# 0.99905 against the CPU spread's 0.044, 4.2e-3, 0.99907. So the mean
# differences are held to twice the CPU's own spread, and the rollout to the
# JAX package's int8 wiring bounds besides (tests/test_qconv.py: max < 0.1,
# corr > 0.995 against fp32). The exact integer products (12a) and the
# calibrations' agreement to 1e-4 are the sharp checks.
INT8_SPREAD_RATIO = 2.0
INT8_ROLLOUT_MAX, INT8_ROLLOUT_CORR = 0.1, 0.995
INT8_REQUESTS = 3
INT8_EVALS_PER_REQUEST = 8  # 4 diffusion + 4 hybrid UNet evals at the (0, 2, 6, 7) defaults
# phase 12c: image size, rollout steps, batches (of the three noise families'
# 2 phantoms each, the first). Its CPU half runs while the kernels build and
# sets that window's length: 128²
CALIBRATION_CHECK = (128, 2, 1)
# 1024² (phase 13): exact attention against flash, both fp32 evals with TF32
# off: flash's fp32 products in three TF32 passes (~1e-6 relative) against
# cuBLAS's fp32 ones, through the rollouts: the bound of the batched-vs-
# single comparison (BATCH_VS_SINGLE_BOUND), for the same reason.
EXACT_VS_FLASH_BOUND = 1e-4
REQUESTS_1024 = 3
# xraybench-v1 on the card (phase 15): the protocol's 256², serve widths,
# the tpu hybrid profile, 8 training phantoms and an epoch scale at which
# every recipe trains its floor of 2 epochs; 1 eval image per noise family.
XB_IMG = 256
XB_ARGS = ["--width-preset", "serve", "--hybrid-profile", "tpu", "--img-size", str(XB_IMG),
           "--n-train", "8", "--epochs-scale", "0.04"]
XB_N_EVAL = 1
XB_ROWS = ["_input", "diffusion", "nafnet", "expert", "hybrid", "diffusion_w96",
           "expert_ftl2(branch)", "diffusion_ddim50@50", "diffusion@50"]
XB_PAYLOAD_KEYS = ["protocol", "img_size", "n_eval", "results"]  # midd_tpu/benchmarks/xray_bench.py:744-745
XB_SCORE_BATCH = 4  # score_fn's batch
XB_EVALS = {"diffusion": 9, "diffusion_w96": 9, "diffusion_ddim50@50": 50, "diffusion@50": 50,
            "hybrid": 9}  # UNet evals a scored batch: exact rollouts of 8 (9 scan steps) or 50
# the hybrid row's rollout is the diffusion row's UNet at the same steps and
# precision: on the CPU it stands for both rollout rows
XB_CARD_VS_CPU_MODELS = ("nafnet", "hybrid")
XB_CARD_VS_CPU_IMAGES = 1  # the eval set's first image (gaussian): the CPU's full-width rollouts set the cost
# Card vs CPU on the trained checkpoints (phase 15c), the CLI's settings (bf16
# UNet evals in both rollouts, fp32 elsewhere), TF32 off: the NAFNet path is
# fp32 on both devices (~1e-6 of max|out| apart, phase 9b), which moves a
# mean PSNR by ~1e-5 dB; XB_PSNR_FP32_DB and XB_SSIM_FP32 hold that and
# would not hold a layer at TF32. The rollout paths evaluate the UNet in
# bf16, rounded at other points on each device (cuDNN's and oneDNN's bf16
# convolutions, the flash kernel against the exact attention): each eval's
# eps is then ~2^-8 of itself apart, and after 9 steps the outputs ~1e-3 per
# pixel apart, random in sign, against an error of ~0.05 rms from clean at
# ~25 dB: ~1e-3 of the MSE, ~0.005 dB, and ~1e-4 of SSIM (measured on an H100
# 80GB HBM3 at 700 W on 2-epoch checkpoints, the eval set's first image:
# diffusion 0.0029 dB and 8.7e-5, hybrid 3.8e-5 dB; one image a family:
# 0.0039 dB and 9.1e-5). XB_PSNR_BF16_DB and XB_SSIM_BF16 leave a margin of
# ~5x over that; a UNet eval on wrong weights or a step missed would move these
# rows by decibels.
XB_PSNR_FP32_DB, XB_SSIM_FP32 = 1e-3, 1e-5
XB_PSNR_BF16_DB, XB_SSIM_BF16 = 0.02, 5e-4
# MODEL2_NAFNET at 512² (phase 14): (C, H = W) of each stage, and its NAFBlocks
MODEL2_STAGES = [(24, 512), (48, 256), (96, 128), (192, 64), (384, 32)]
MODEL2_BLOCKS = sum(config.MODEL2_NAFNET.enc_blk_nums) + config.MODEL2_NAFNET.middle_blk_num + sum(
    config.MODEL2_NAFNET.dec_blk_nums)

# Tensor- and data-parallel serving on the one card (phase 17), 512², fp32
# with TF32 off. The parameters that the tp rule splits in the SERVE_*
# engine with demo weights at tp 2, as the JAX engine counts them
# (``n_tp_sharded``; computed with JAX by tests/test_torch_tp_serve.py):
# 2 x 48 (the standalone and the hybrid's UNet) + 2 x 85 (the NAFNets)
# + 13 (expert) + 3 (router) + 0 (fusion).
TP2_SERVE_SHARDED = 282
PARALLEL_REQUESTS = 3
# tp 2 against the unsharded engine: each split convolution is cuDNN's
# convolution of half the output channels, which may run another algorithm
# (sums in another order, ~1e-6 relative per layer) through the 9-step
# rollouts, as a batch against its images alone (BATCH_VS_SINGLE_BOUND).
TP_FP32_BOUND = 1e-4
# the default engine's bf16 UNet evals at tp 2: where a split convolution's
# sum rounds to the other neighbouring bf16 value (2^-8 relative), the eps
# of that eval moves by it, and the rollout carries the change on
TP_BF16_BOUND = 5e-2
# dp 2 on one card: each replica runs its row at batch 1 on its own thread,
# the unsharded engine's shapes, so the same kernels
DP_VS_ONE_BOUND = 1e-6
# Tensor-parallel training on the one card (phase 18a, 18b), 512², fp32
# with TF32 off: the recipes CLI at --mesh 1,1,2 (diffusion) and 2,1,2
# (NAFNet), ranks under torchrun over gloo, against the same CLI in one
# process, held to phase 16's bounds (DP_*). The split counts are the JAX
# trainer's ``count_tp_sharded`` at tp 2 (computed with JAX by
# tests/test_torch_tp_train.py).
TP_MODELS = ("nafnet", "diffusion")
TP_MESH = {"nafnet": "2,1,2", "diffusion": "1,1,2"}
TP_BATCH = {"nafnet": 2, "diffusion": 1}
TP_STEPS = {"nafnet": 2, "diffusion": 3}
TP_PAIRS = {m: TP_STEPS[m] * TP_BATCH[m] for m in TP_MODELS}
TP2_TRAIN_SHARDED = {"nafnet": 85, "diffusion": 48}
# int8 under tp 2 (phase 18c) against the unsharded int8 engine on the same
# calibrated scales: each slice computes its rows' exact int32 products
INT8_TP_BOUND = 1e-4
# Spatial-parallel serving on the one card (phase 19), 512², fp32 with TF32
# off: each row block is cuDNN's convolution of fewer output rows, which may
# run another algorithm, as tp's half-width convolutions may (TP_FP32_BOUND)
SP_FP32_BOUND = 1e-4
# Spatial-parallel training (phase 19b): the same runs as tp's (TP_*), at
# --mesh 1,2,1 (diffusion, 2 ranks) and 2,2,1 (NAFNet, 4 ranks)
SP_MESH = {"nafnet": "2,2,1", "diffusion": "1,2,1"}
# Training at sp and tp together (phase 21): the same runs again (TP_*
# pairs, batches and steps, held to the same one-process runs and DP_*
# bounds), at --mesh 1,2,2 (diffusion, a run of the 4-rank launch) and
# 2,2,2 (NAFNet, 8 ranks on the one card, first, before the 4- and 2-rank
# launches: beside the 2-rank one the 8 ranks ran out of the card's 80 GB)
SPTP_MESH = {"nafnet": "2,2,2", "diffusion": "1,2,2"}
# where a parallel run's NAFNet .pth is resumed in another launch (and in
# this process): tp's and sp's in the 2-rank launch, sp x tp's in the
# 4-rank one (the 2-rank launch is the longer of the two)
RESUME_MESH = {"tp": "1,1,2", "sp": "1,2,1", "sptp": "2,1,2"}
# The FLOP counter on the card (phase 20): counts at 256² in bf16 on the
# canonical plain layout (UNetDiffusion(fuse_updown=False, use_flash=False)),
# equal to the JAX package's count_flops of the same functions (recomputed
# with JAX by tests/test_torch_flops.py): the UNet and NAFNet forwards at
# batch 1, one training step of each (the trainer's loss, forward and
# backward) at batch 2, and bench.py's DDIM-50 rollout (50 forwards).
FLOPS_UNET_FWD = 117_942_368_256
FLOPS_NAFNET_FWD = 28_140_871_680
FLOPS_DIFFUSION_STEP = 665_342_558_208
FLOPS_NAFNET_STEP = 175_226_339_328
FLOPS_DDIM50 = 5_897_118_412_800
@contextlib.contextmanager
def carried_scales(scales: dict):
    """Engines built inside the block serve ``scales`` (name -> scales, in
    the order an engine calibrates: diffusion, then hybrid) in place of a
    calibration of their own."""
    calibrate, carried = engine_module.calibrate_unet_rollout, iter(list(scales.values()))
    engine_module.calibrate_unet_rollout = lambda *args: next(carried)
    try:
        yield
    finally:
        engine_module.calibrate_unet_rollout = calibrate


T_START = time.time()


def phase(name: str) -> None:
    print(f"== {name} (at {time.time() - T_START:.1f} s)", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Median device time of one call, from CUDA events around each call, or
    around ``batch`` calls in a row (divided by ``batch``), so that the host's
    time to enqueue a call hides behind the device's work on the one before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def default_tf32() -> None:
    """torch's defaults, as the server and the trainer run: fp32 matmuls
    exact, convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def flash_bound(flops: float, nbytes: float, dtype) -> tuple:
    """(bound ms, what bounds it) of a tensor-core kernel (flash, naf_ffn):
    its operations over the tensor-core peak of its dtype (fp32: the TF32
    peak, the least time any unit of the card could take), or its bytes over
    the HBM rate."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_timings(rows: list) -> dict:
    """The kernels-line keys of the timed flash shapes: the times at the
    fp32 training shape (the one fp32 shape timed), and at every shape."""
    keys = ("n", "d", "dtype", "ms", "ms_batched", "bound_ms", "bound_by", "library_ms",
            "library_ms_batched")
    fp32 = next(r for r in rows if r["dtype"] == "float32")
    return {"fp32": {k: fp32[k] for k in keys[3:] if k in fp32 and k != "bound_by"},
            "timings": [{k: r[k] for k in keys if k in r} for r in rows]}


def check_kernel(report: dict) -> dict:
    """Phase 3: the forward kernel against its plain version, timed at every
    D 96 case (the served sequence lengths in bf16, the training shape in
    fp32) and D 192 case (the wide UNet's) beside SDPA in the same dtype and
    the bound; returns its
    kernels-line entry (launches filled in by the main paths)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(0)
    rows, timed = [], []
    for bh, n, d, dtype in CASES:
        q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(3))
        o, lse = fa.flash_attention(q, k, v)
        o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        max_o = o_ref.abs().max().item()
        tol_o = BF16_O_REL * max_o if dtype == torch.bfloat16 else TOL_FP32
        err_o = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (err_o <= tol_o and err_lse <= TOL_FP32
              and o.dtype == dtype and lse.dtype == torch.float32)
        row = {"bh": bh, "n": n, "d": d, "dtype": _dt(dtype),
               "max_abs_o": max_o, "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": tol_o, "tol_lse": TOL_FP32, "ok": ok}
        if d in TIMED_D:
            q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
            bound, by = flash_bound(4.0 * bh * n * n * d, 4 * bh * n * d * q.element_size() + bh * n * 4, dtype)
            for key, fn in (("ms", lambda: fa.flash_attention(q, k, v)),
                            ("library_ms", lambda: F.scaled_dot_product_attention(q4, k4, v4))):
                row[key] = time_ms(fn)
                row[f"{key}_batched"] = time_ms(fn, batch=FLASH_BATCH)
            row.update({"bound_ms": bound, "bound_by": by})
            timed.append(row)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {row}")
        if (bh, n, d, dtype) == MAIN:
            main_row, main_qkv = row, (q, k, v)
    report["kernel_cases"] = rows

    bh, n, d, _ = MAIN
    qf, kf, vf = (t.float() for t in main_qkv)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "midd_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "midd_tpu/ops/flash_attention.py:51",
        "launches": None,
        "max_abs_err": main_row["max_abs_err_o"],
        "ms": main_row["ms"],
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(qf, kf, vf), reps=10),
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": "scaled_dot_product_attention, same dtype",
        "shape": [bh, n, d],
        "dtype": "bfloat16",
        **flash_timings(timed),
    }


KERNEL_COUNTERS = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
                   "flash_bwd_dkv": fa.flash_bwd_dkv, "ln2d": ln.ln2d, "naf_ffn": ffn.naf_ffn_fused}


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}


def zero_counts() -> None:
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0


# The CPU halves of the card-vs-CPU checks of phases 9, 10 and 12c, run on
# another thread while the kernels build (``prefetch_cpu_sides``): each check
# computes on each device through ``on_devices`` from seeded inputs, so its
# CPU half is the same function whenever it runs.
CPU_SIDES: dict = {}
_PREFETCH = threading.local()


class _Prefetched(Exception):
    """Ends a phase function that ran for its CPU halves only."""


def on_devices(key: str, side, devices=("cuda", "cpu")) -> dict:
    """``side(dev)`` for each of ``devices``; a CPU device's result is the
    one ``prefetch_cpu_sides`` computed, where it ran."""
    if getattr(_PREFETCH, "on", False):
        for dev in devices:
            if dev != "cuda":
                CPU_SIDES[key, dev] = side(dev)
        raise _Prefetched
    return {dev: CPU_SIDES.pop((key, dev)) if (key, dev) in CPU_SIDES else side(dev) for dev in devices}


def prefetch_cpu_sides(checks) -> float:
    """Run each check function of ``checks`` up to its ``on_devices`` call
    and compute its CPU halves there (on the calling thread, while the
    main one waits for the build); the card's flags are left as they were.
    Returns the seconds it took."""
    t = time.time()
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    _PREFETCH.on = True
    try:
        for check in checks:
            try:
                check({})
            except _Prefetched:
                pass
    finally:
        _PREFETCH.on = False
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return time.time() - t


def since(before: dict) -> dict:
    return {k: v - before[k] for k, v in counts().items()}


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward on (BH, N, D) operands, dq, dk and dv together: the
    device time under ``torch.profiler`` of the kernels of one forward +
    ``autograd.grad`` less those of one forward (median of 3 each). Events
    around the call would count autograd's host time, which exceeds the
    device's at these shapes."""
    bh, n, d = q.shape
    q4, k4, v4 = (t.view(1, bh, n, d).clone().requires_grad_(True) for t in (q, k, v))
    do4 = do.view(1, bh, n, d)

    def fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4)

    fwd_bwd(), fwd()
    device = lambda fn: statistics.median(sum(device_profile(fn)[0].values()) for _ in range(3))  # noqa: E731
    return device(fwd_bwd) - device(fwd)


def check_bwd(report: dict) -> list:
    """Phase 4: the two backward kernels against their plain versions, each
    timed at every D 96 and D 192 case beside SDPA's backward in the same
    dtype and its bound; returns their kernels-line entries (launches filled
    in by the main paths)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(1)
    rows, timed = [], {"dq": [], "dkv": []}
    for bh, n, d, dtype in BWD_CASES:
        q, k, v, do = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v)
        delta = fa._delta(o, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        ref_dq = fa.bwd_dq_plain(q, k, v, do, lse, delta)
        ref_dk, ref_dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        rel = BWD_BF16_REL if dtype == torch.bfloat16 else BWD_FP32_REL
        row = {"bh": bh, "n": n, "d": d, "dtype": _dt(dtype), "ok": True}
        for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            max_ref = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            row[name] = {"max_abs": max_ref, "max_abs_err": err, "tol": rel * max_ref}
            row["ok"] &= got.dtype == dtype and got.shape == q.shape and err <= rel * max_ref
        if d in TIMED_D:
            calls = {"dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
                     "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta)}
            ms = {key: time_ms(fn) for key, fn in calls.items()}
            ms_batched = {key: time_ms(fn, batch=FLASH_BATCH) for key, fn in calls.items()}
            library_ms = sdpa_bwd_ms(q, k, v, do)
            in_bytes = 4 * bh * n * d * q.element_size() + 2 * bh * n * 4  # q, k, v, dO; lse, delta
            for key, products, outs in (("dq", 3, 1), ("dkv", 4, 2)):
                bound, by = flash_bound(products * 2.0 * bh * n * n * d,
                                        in_bytes + outs * bh * n * d * q.element_size(), dtype)
                timed[key].append({"n": n, "d": d, "dtype": _dt(dtype), "ms": ms[key],
                                   "ms_batched": ms_batched[key], "bound_ms": bound,
                                   "bound_by": by, "library_ms": library_ms})
            row.update({"ms": ms, "ms_batched": ms_batched})
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"flash backward disagrees with its plain version: {row}")
        if (bh, n, d, dtype) == MAIN:
            main_row, main_in = row, (q, k, v, do, lse, delta)
    report["bwd_cases"] = rows

    bh, n, d, _ = MAIN
    q, k, v, do, lse, delta = main_in
    plain = {"dq": time_ms(lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta), reps=10),
             "dkv": time_ms(lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta), reps=10)}
    entries = []
    for name, line, errs in (
        ("flash_bwd_dq", 98, [main_row["dq"]["max_abs_err"]]),
        ("flash_bwd_dkv", 132, [main_row["dk"]["max_abs_err"], main_row["dv"]["max_abs_err"]]),
    ):
        key = name.split("_")[-1]
        main_t = next(r for r in timed[key] if (r["n"], r["d"], r["dtype"]) == (n, d, "bfloat16"))
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "midd_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"midd_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(errs),
            "ms": main_t["ms"],
            "plain_ms": plain[key],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "library": "scaled_dot_product_attention backward, same dtype: device time of "
                       "(forward + autograd.grad) - forward under torch.profiler, dq, dk and dv together",
            "shape": [bh, n, d],
            "dtype": "bfloat16",
            **flash_timings(timed[key]),
        })
    return entries


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _kernel_cases():
    """(b, c, h, w, dtype, layout): every SERVE_NAFNET stage of a 512² input
    at batch 1 and 2, and the ragged shape, in fp32 and bf16, NCHW; and at
    batch 1 in channels-last, the layout the engine's and the trainer's
    activations take (cuDNN keeps it from their permuted NHWC inputs). Then
    every stage at the hybrid trainer's batch of 6 in fp32, the frozen
    NAFNet's dtype there, in both layouts: channels-last from the CLI's
    batches, NCHW from phase 10d's."""
    shapes = [(b, c, s, s, "nchw") for c, s in NAF_STAGES for b in (1, 2)]
    shapes += [(1, c, s, s, "channels_last") for c, s in NAF_STAGES]
    shapes += [(2, *NAF_RAGGED, layout) for layout in ("nchw", "channels_last")]
    cases = [(*shape[:4], dtype, shape[4]) for shape in shapes for dtype in (torch.float32, torch.bfloat16)]
    return cases + [(HYBRID_BATCH, c, s, s, torch.float32, layout)
                    for c, s in NAF_STAGES for layout in ("channels_last", "nchw")]


def _in_layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "channels_last_offset":  # channels-last strides, not 16-byte aligned
        b, c, h, w = x.shape
        flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
        view = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
        view.copy_(x)
        assert view.is_contiguous(memory_format=torch.channels_last) and view.data_ptr() % 16 != 0
        return view
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _isolated_sums(stage_rows: dict, keys: tuple) -> dict:
    """Per layout, the sum over one SERVE_NAFNET forward at 512², batch 1,
    fp32 of a per-call number: each stage's isolated call times its calls
    per forward. Computed, not measured in a forward: there the input was
    just written by the layer before, and the time can differ."""
    return {layout: {k: sum(r[k] * r["calls_per_forward"] for r in rows) for k in keys}
            for layout, rows in stage_rows.items()}


def served_ln2d_layouts() -> dict:
    """The layouts of the LayerNorm2d inputs of SERVE_NAFNET on a bucket-8
    batch at 256², fed as the engine feeds it (its NHWC arrays permuted to
    NCHW): {(C, H): sorted layouts seen there, "channels_last" or "nchw"}.
    cuDNN picks each convolution's output layout, so both can occur."""
    model = EnhancedNAFNet(config.SERVE_NAFNET)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    seen = {}

    def record(mod, args):
        x = args[0]
        cl = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
        seen.setdefault((x.shape[1], x.shape[2]), set()).add("channels_last" if cl else "nchw")

    hooks = [m.register_forward_pre_hook(record) for m in model.modules() if isinstance(m, LayerNorm2d)]
    x = torch.from_numpy(np.zeros((SERVE_BUCKET, 256, 256, 1), np.float32)).permute(0, 3, 1, 2).cuda()
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    assert set(seen) == set(NAF_STAGES_256), sorted(seen)
    return {stage: sorted(layouts) for stage, layouts in seen.items()}


def check_ln2d(report: dict) -> dict:
    """Phase 5: the LayerNorm2d kernel against its plain version; returns its
    kernels-line entry (launches filled in from the main paths)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(2)
    rows, stage_rows = [], {"nchw": [], "channels_last": []}
    served = served_ln2d_layouts()
    report["ln2d_layouts_bucket8_256"] = {f"C{c}@{h}": layouts for (c, h), layouts in served.items()}
    print(json.dumps({"ln2d_layouts_bucket8_256": report["ln2d_layouts_bucket8_256"]}), flush=True)
    bucket8 = [(SERVE_BUCKET, c, s, s, dtype, layout) for c, s in NAF_STAGES_256
               for layout in served[(c, s)] for dtype in (torch.float32, torch.bfloat16)]
    cases = ([(*case, True) for case in _kernel_cases()]
             + [(*case, False) for case in LN_EDGE_CASES + bucket8])
    for b, c, h, w, dtype, layout, timed in cases:
        x = (2.5 + torch.randn(b, c, h, w, generator=gen)).to("cuda", dtype)  # mean 2.5x the spread
        x = _in_layout(x, layout)
        scale = (1 + 0.2 * torch.randn(c, generator=gen)).cuda()
        bias = (0.2 * torch.randn(c, generator=gen)).cuda()
        y = ln.ln2d(x, scale, bias)
        ref = ln.ln2d_plain(x, scale, bias)
        torch.cuda.synchronize()
        max_y = ref.float().abs().max().item()
        tol = (LN_BF16_REL if dtype == torch.bfloat16 else LN_FP32_REL) * max_y
        err = (y.float() - ref.float()).abs().max().item()
        row = {"shape": [b, c, h, w], "dtype": _dt(dtype), "layout": layout, "max_abs_y": max_y,
               "max_abs_err": err, "tol": tol, "bitwise_equal": bool(torch.equal(y, ref)),
               "ok": (err <= tol and y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
                      and (dtype != torch.float32 or torch.equal(y, ref)))}
        if timed and b == 1:  # the served batch: times, bound and yardstick
            p, elt = b * h * w, x.element_size()
            t_bytes = (2 * p * c * elt + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 8.0 * p * c / PEAK_FP32_FLOPS * 1e3
            xcl = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()  # made once, outside the timing
            sc, bi = scale.to(dtype), bias.to(dtype)
            kernel = lambda: ln.ln2d(x, scale, bias)  # noqa: E731
            library = lambda: F.layer_norm(xcl, (c,), sc, bi, 1e-6)  # noqa: E731
            row.update({
                "ms": time_ms(kernel), "ms_batched": time_ms(kernel, batch=FLASH_BATCH),
                "plain_ms": time_ms(lambda: ln.ln2d_plain(x, scale, bias), reps=5, warmup=1),
                "library_ms": time_ms(library), "library_ms_batched": time_ms(library, batch=FLASH_BATCH),
                # one call's kernels under the profiler: no host time, which
                # sets both timings above at the narrow stages
                "device_ms": sum(device_profile(kernel)[0].values()),
                "library_device_ms": sum(device_profile(library)[0].values()),
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "calls_per_forward": 2 * NAF_BLOCKS.get(c, 0),
            })
            if dtype == torch.float32 and c in NAF_BLOCKS:
                stage_rows[layout].append(row)
        print(json.dumps({"ln2d": row}), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"ln2d disagrees with its plain version: {row}")
    report["ln2d_cases"] = rows
    report["ln2d_sum_of_isolated_calls_per_forward"] = _isolated_sums(
        stage_rows, ("ms", "ms_batched", "device_ms", "plain_ms", "bound_ms", "library_ms",
                     "library_ms_batched", "library_device_ms"))
    # C 32 at 512², batch 1, fp32, channels-last: the largest call, in the
    # layout of the served and trained NAFNet
    main = stage_rows["channels_last"][0]
    return {
        "name": "ln2d", "route": "cuda", "source": "midd_tpu_torch/csrc/ln2d.cu",
        "replaces": "midd_tpu/ops/ln2d.py:66", "replaces_also": "midd_tpu/ops/ln2d.py:102",
        "launches": None, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "F.layer_norm over the last dim of a pre-made (P, C) channels-last copy",
        "shape": main["shape"], "dtype": "float32", "layout": main["layout"],
        "ms_batched": main["ms_batched"], "library_ms_batched": main["library_ms_batched"],
        "device_ms": main["device_ms"], "library_device_ms": main["library_device_ms"],
    }


def _ffn_params(c: int, gen: torch.Generator):
    """norm2 scale and bias, conv4 and conv5 as the port's modules hold them
    (LeCun-normal weights), and gamma: non-trivial values, on the card."""
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    return [t.cuda() for t in (1 + 0.2 * r(c), 0.2 * r(c), r(2 * c, c, 1, 1) * c ** -0.5,
                               0.1 * r(2 * c), r(c, c, 1, 1) * c ** -0.5, 0.1 * r(c), 0.2 * r(1, c, 1, 1))]


def check_naf_ffn(report: dict) -> dict:
    """Phase 6: the fused FFN kernel against its plain version; returns its
    kernels-line entry (launches filled in from the fused forward)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(4)
    rows, stage_rows = [], {"nchw": [], "channels_last": []}
    for b, c, h, w, dtype, layout in _kernel_cases():
        y = _in_layout(torch.randn(b, c, h, w, generator=gen).to("cuda", dtype), layout)
        params = _ffn_params(c, gen)
        out = ffn.naf_ffn_fused(y, *params)
        ref = ffn.naf_ffn_plain(y, *params)
        torch.cuda.synchronize()
        max_out = ref.float().abs().max().item()
        tol = (FFN_BF16_REL if dtype == torch.bfloat16 else FFN_FP32_REL) * max_out
        err = (out.float() - ref.float()).abs().max().item()
        row = {"shape": [b, c, h, w], "dtype": _dt(dtype), "layout": layout, "max_abs_out": max_out,
               "max_abs_err": err, "tol": tol,
               "ok": err <= tol and out.dtype == dtype and out.shape == y.shape and out.stride() == y.stride()}
        if b == 1:
            p, elt = b * h * w, y.element_size()
            # 6 P C^2 for the two products, ~12 P C for the norm, gate, bias
            # and residual, at the tensor cores' rate (TF32 for fp32 y); y
            # read and out written once, the fp32 parameters read once
            bound, bound_by = flash_bound(6.0 * p * c * c + 12.0 * p * c,
                                          2 * p * c * elt + (3 * c * c + 7 * c) * 4, dtype)
            kernel = lambda: ffn.naf_ffn_fused(y, *params)  # noqa: E731
            row.update({
                "ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: ffn.naf_ffn_plain(y, *params)),
                "library_ms": None,
                # one call's kernels under the profiler (bf16: with the
                # wrapper's two weight casts), no host time
                "device_ms": sum(device_profile(kernel)[0].values()),
                "bound_ms": bound, "bound_by": bound_by,
                "calls_per_forward": NAF_BLOCKS.get(c, 0),
            })
            if dtype == torch.float32 and c in NAF_BLOCKS:
                stage_rows[layout].append(row)
        print(json.dumps({"naf_ffn": row}), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"naf_ffn disagrees with its plain version: {row}")
    report["naf_ffn_cases"] = rows
    report["naf_ffn_sum_of_isolated_calls_per_forward"] = _isolated_sums(
        stage_rows, ("ms", "device_ms", "plain_ms", "bound_ms"))
    main = stage_rows["nchw"][0]  # C 32 at 512², fp32, NCHW: the layout of phase 7's input
    return {
        "name": "naf_ffn", "route": "cuda", "source": "midd_tpu_torch/csrc/naf_ffn.cu",
        "replaces": "midd_tpu/ops/naf_ffn.py:32", "launches": None,
        "max_abs_err": main["max_abs_err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes LayerNorm -> 1x1 -> SimpleGate -> 1x1 -> residual",
        "shape": main["shape"], "dtype": "float32", "layout": main["layout"],
        "device_ms": main["device_ms"],
    }


def perturbed_nafnet(seed: int, cfg: config.NAFNetConfig = config.SERVE_NAFNET) -> EnhancedNAFNet:
    """A NAFNet (SERVE_NAFNET unless ``cfg``) with seeded LeCun-normal convs
    (``init_weights``) and random biases, norm scales and NAFBlock
    beta/gamma, on the CPU: with the initial zero beta and gamma every
    NAFBlock is the identity."""
    model = init_weights(EnhancedNAFNet(cfg), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "beta", "gamma")):
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
            elif ".norm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return model


def fused_forward(report: dict, profile: bool) -> dict:
    """Phase 7: ``nafnet_apply_fused`` at SERVE_NAFNET, 512², fp32, against the
    module's forward on the card; with ``profile`` (``--report``), the device
    time by kernel kind of one call of each. Returns the launches of the
    fused forward."""
    set_tf32(False)
    model = perturbed_nafnet(7).cuda().eval()
    x = torch.from_numpy(np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 13))), np.float32) / 255)
    x = x[None, None].cuda()
    with torch.inference_mode():
        zero_counts()
        out = nafnet_apply_fused(model, x)
        torch.cuda.synchronize()
        launched = counts()
        ref = model(x)
        res = {"shape": list(out.shape), "max_abs_ref": ref.abs().max().item(),
               "max_abs_err": (out - ref).abs().max().item(), "launches": launched,
               "fused_ms": time_ms(lambda: nafnet_apply_fused(model, x), reps=10),
               "module_ms": time_ms(lambda: model(x), reps=10)}
        if profile:
            res["device_ms_by_kind"] = {"fused": device_profile(lambda: nafnet_apply_fused(model, x))[1],
                                        "module": device_profile(lambda: model(x))[1]}
    res["tol"] = NAFNET_FUSED_REL * res["max_abs_ref"]
    report["nafnet_apply_fused"] = res
    print(json.dumps({"nafnet_apply_fused": res}), flush=True)
    assert launched == {**NO_LAUNCHES, "naf_ffn": 30}, launched
    assert torch.isfinite(out).all() and out.shape == (1, 1, 512, 512)
    assert res["max_abs_err"] <= res["tol"], res
    del model
    torch.cuda.empty_cache()
    return launched


def nafnet_card_vs_cpu(report: dict) -> None:
    """Phase 9b: one fp32 NAFNet forward at 256², card against CPU, same
    perturbed weights and input."""
    set_tf32(False)
    x = torch.from_numpy(np.asarray(Image.open(io.BytesIO(xray_png(256, 256, 17))), np.float32) / 255)

    def side(dev):
        model = perturbed_nafnet(11).to(dev).eval()
        with torch.inference_mode():
            zero_counts()
            return model(x[None, None].to(dev)).cpu(), counts()

    both = on_devices("nafnet_card_vs_cpu", side)
    outs, card_launches = {dev: out for dev, (out, _) in both.items()}, both["cuda"][1]
    diff = (outs["cuda"] - outs["cpu"]).abs().max().item()
    top = outs["cpu"].abs().max().item()
    res = {"max_abs_diff": diff, "max_abs_out": top, "bound": NAFNET_CARD_VS_CPU_REL * top,
           "launches": card_launches}
    report["nafnet_card_vs_cpu"] = res
    print(json.dumps({"nafnet_card_vs_cpu": res}), flush=True)
    assert card_launches == {**NO_LAUNCHES, "ln2d": 60}, card_launches
    assert torch.isfinite(outs["cuda"]).all() and diff <= res["bound"], res


def worst_grad_ratio(g_gpu: dict, g_cpu: dict) -> tuple:
    """The largest card-vs-CPU gradient difference over all parameters, each
    divided by its CPU gradient's largest entry (floored at 1e-3 of the
    model's largest, see STEP_GRAD_REL), and the parameter it occurs in."""
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, None
    for name, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-3 * top)
        ratio = (g_gpu[name] - g).abs().max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def nafnet_step_card_vs_cpu(report: dict) -> None:
    """Phase 10b: one NAFNet training step's loss and gradients on both
    devices (the reference CombinedLoss), and a gradient for every
    LayerNorm2d weight and bias and for the convolutions in front of them."""
    set_tf32(False)
    rng = np.random.default_rng(6)
    clean = np.stack([np.asarray(Image.open(io.BytesIO(xray_png(128, 128, 40 + i))), np.float32) / 255
                      for i in range(2)])[:, None]
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)

    def side(dev):
        model = perturbed_nafnet(23).to(dev)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (clean, noisy))
        zero_counts()
        loss, _ = nafnet_loss_fn("reference")(model, batch, no_draw(batch, None))
        loss.backward()
        launched = counts()
        norms = [n for n, m in model.named_modules() if isinstance(m, LayerNorm2d)]
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}, launched, norms

    out = on_devices("nafnet_step_card_vs_cpu", side)
    (l_gpu, g_gpu, launched, norms), (l_cpu, g_cpu, _, _) = out["cuda"], out["cpu"]
    worst, worst_name = worst_grad_ratio(g_gpu, g_cpu)
    norm_grads = [f"{n}.{k}" for n in norms for k in ("weight", "bias")]
    dead = [n for n in norm_grads + [n for n in g_gpu if n.endswith(("conv1.weight", "conv4.weight"))]
            if not (torch.isfinite(g_gpu[n]).all() and g_gpu[n].abs().max() > 0)]
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_ratio": worst, "worst_param": worst_name, "grad_bound": STEP_GRAD_REL,
           "n_params": len(g_cpu), "norms": len(norms), "params_without_gradient": dead,
           "launches": launched}
    report["nafnet_step_card_vs_cpu"] = res
    print(json.dumps({"nafnet_step_card_vs_cpu": res}), flush=True)
    assert launched == {**NO_LAUNCHES, "ln2d": 60} and len(norms) == 60, (launched, len(norms))
    assert not dead, dead
    assert np.isfinite(l_gpu) and res["loss_rel_diff"] <= STEP_LOSS_REL, res
    assert worst <= STEP_GRAD_REL, res


def _step_card_vs_cpu(key: str, build, loss_fn, batch: tuple, draw: tuple, want: dict, report: dict) -> None:
    """One training step's loss and every gradient on both devices: the
    model from ``build()`` (seeded, on the CPU), the NCHW numpy ``batch``
    and ``draw`` (t as int64, the rest fp32) moved to each device."""
    set_tf32(False)

    def side(dev):
        model = build().to(dev)
        b = tuple(torch.from_numpy(a).to(dev) for a in batch)
        d = tuple(torch.from_numpy(a).to(dev) for a in draw)
        zero_counts()
        loss, _ = loss_fn(model, b, d)
        loss.backward()
        launched = counts()
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}, launched

    out = on_devices(key, side)
    (l_gpu, g_gpu, launched), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    worst, worst_name = worst_grad_ratio(g_gpu, g_cpu)
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_ratio": worst, "worst_param": worst_name, "grad_bound": STEP_GRAD_REL,
           "n_params": len(g_cpu), "launches": launched, "expected_launches": want}
    report[key] = res
    print(json.dumps({key: res}), flush=True)
    assert launched == want, res
    assert np.isfinite(l_gpu) and res["loss_rel_diff"] <= STEP_LOSS_REL, res
    assert worst <= STEP_GRAD_REL, res


def train_step_card_vs_cpu(report: dict) -> None:
    """Phase 10a: one diffusion training step's loss and gradients on both
    devices, on a fixed draw: 6 flash forward, 6 dq and 6 dk/dv launches."""
    size = 128
    rng = np.random.default_rng(5)
    clean = np.asarray(Image.open(io.BytesIO(xray_png(size, size, 11))), np.float32)[None, None] / 255
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    eps = rng.standard_normal(clean.shape).astype(np.float32)
    t = np.array([23])
    sched = make_schedule(config.SERVE_SCHEDULE)
    ah = sched.alpha_hat[t].item()
    x_t = (np.sqrt(ah) * clean + np.sqrt(1 - ah) * eps).astype(np.float32)
    _step_card_vs_cpu(
        "train_step_card_vs_cpu",
        lambda: init_weights(UNetDiffusion(config.SERVE_DIFFUSION), torch.Generator().manual_seed(0)),
        diffusion_loss_fn(sched), (clean, noisy), (t, x_t, eps),
        {**NO_LAUNCHES, "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}, report)


def _step_batch(seed: int, size: int = 128, b: int = 2):
    """A (clean, noisy) batch of seeded radiographs, NCHW numpy, fp32."""
    rng = np.random.default_rng(seed)
    clean = np.stack([np.asarray(Image.open(io.BytesIO(xray_png(size, size, seed + i))), np.float32) / 255
                      for i in range(b)])[:, None]
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    return clean, noisy


def _rel_l2(got: dict, want: dict) -> tuple:
    """The largest ||got - want|| / ||want|| over the tensors, and its name."""
    return max(((got[n] - w).norm().item() / max(w.norm().item(), 1e-30), n) for n, w in want.items())


def expert_step_card_vs_cpu(report: dict) -> None:
    """Phase 10c: one expert training step (train-mode BatchNorm, the
    reference HybridLoss) at SERVE_EXPERT, batch 2: its loss, every gradient
    (EXPERT_GRAD_REL_L2) and both running buffers of every BatchNorm on both
    devices, beside the CPU's own spread when the weights move by one ulp."""
    set_tf32(False)
    clean, noisy = _step_batch(50)

    def side(dev):
        model = init_weights(ExpertDenoiser(config.SERVE_EXPERT), torch.Generator().manual_seed(29))
        with torch.no_grad():
            for p in model.parameters():
                if dev == "cpu_one_ulp":
                    p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
                elif dev == "cpu_tf32_weights":
                    p.view(torch.int32).bitwise_and_(~0x1FFF)
        model = model.to(dev.split("_")[0])
        batch = tuple(torch.from_numpy(a).to(dev.split("_")[0]) for a in (clean, noisy))
        zero_counts()
        loss, _ = expert_loss_fn()(model.train(), batch, no_draw(batch, None))
        loss.backward()
        launched = counts()
        stats = {n: b.detach().cpu() for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}, launched, stats

    out = on_devices("expert_step_card_vs_cpu", side, ("cuda", "cpu", "cpu_one_ulp", "cpu_tf32_weights"))
    (l_gpu, g_gpu, launched, s_gpu), (l_cpu, g_cpu, _, s_cpu) = out["cuda"], out["cpu"]
    bns = sum(isinstance(m, BatchNorm2d) for m in ExpertDenoiser(config.SERVE_EXPERT).modules())
    rel_l2, rel_l2_name = _rel_l2(g_gpu, g_cpu)
    worst_stat = max((s_gpu[n] - v).abs().max().item() / v.abs().max().item() for n, v in s_cpu.items())
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_rel_l2": rel_l2, "worst_grad_rel_l2_param": rel_l2_name, "grad_bound": EXPERT_GRAD_REL_L2,
           "worst_grad_ratio": worst_grad_ratio(g_gpu, g_cpu), "n_params": len(g_cpu),
           **{k: {"worst_grad_rel_l2": _rel_l2(out[k][1], g_cpu), "worst_grad_ratio": worst_grad_ratio(out[k][1], g_cpu)}
              for k in ("cpu_one_ulp", "cpu_tf32_weights")},
           "batchnorms": bns, "worst_stat_ratio": worst_stat, "stat_bound": STEP_STATS_REL, "launches": launched}
    report["expert_step_card_vs_cpu"] = res
    print(json.dumps({"expert_step_card_vs_cpu": res}), flush=True)
    assert launched == NO_LAUNCHES and len(s_cpu) == 2 * bns == 26, res
    assert np.isfinite(l_gpu) and res["loss_rel_diff"] <= STEP_LOSS_REL, res
    assert rel_l2 <= EXPERT_GRAD_REL_L2 and worst_stat <= STEP_STATS_REL, res
    assert res["cpu_tf32_weights"]["worst_grad_rel_l2"][0] > EXPERT_GRAD_REL_L2, res


def hybrid_frozen(seed: int) -> dict:
    """The hybrid's frozen backends at HybridConfig() widths, seeded, on the
    CPU: a perturbed NAFNet (non-identity NAFBlocks) and a UNet."""
    unet = init_weights(UNetDiffusion(config.HybridConfig().diffusion), torch.Generator().manual_seed(seed))
    return {"nafnet": perturbed_nafnet(seed + 1), "unet": unet}


def hybrid_step_launches(cfg: config.HybridConfig) -> dict:
    """A hybrid step's launches: 6 attention blocks per UNet eval over the
    rollout's steps (all fresh), 2 norms per NAFBlock of one NAFNet forward."""
    evals = len(timestep_sequence(cfg.schedule.noise_steps, cfg.training_diffusion_steps))
    return {**NO_LAUNCHES, "flash_fwd": 6 * evals, "ln2d": 60}


def hybrid_step_card_vs_cpu(report: dict) -> None:
    """Phase 10d: one hybrid training step (HybridConfig(), seeded frozen
    backends, the 10-step fp32 rollout, the reference PerceptualLoss) at
    batch 2: its loss and every router and fusion gradient on both devices,
    and the launches of the frozen backends' forward kernels (no backward)."""
    set_tf32(False)
    cfg = config.HybridConfig()
    clean, noisy = _step_batch(60)

    def side(dev):
        frozen = {k: m.to(dev).eval().requires_grad_(False) for k, m in hybrid_frozen(31).items()}
        model = init_weights(RouterFusion(cfg.router, cfg.fusion), torch.Generator().manual_seed(37)).to(dev)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (clean, noisy))
        zero_counts()
        loss, _ = hybrid_loss_fn(make_schedule(cfg.schedule, dev), cfg.training_diffusion_steps)(
            model, batch, no_draw(batch, None), frozen)
        loss.backward()
        launched = counts()
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}, launched

    out = on_devices("hybrid_step_card_vs_cpu", side)
    (l_gpu, g_gpu, launched), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    worst, worst_name = worst_grad_ratio(g_gpu, g_cpu)
    want = hybrid_step_launches(cfg)
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_ratio": worst, "worst_param": worst_name, "grad_bound": STEP_GRAD_REL,
           "n_params": len(g_cpu), "launches": launched, "expected_launches": want}
    report["hybrid_step_card_vs_cpu"] = res
    print(json.dumps({"hybrid_step_card_vs_cpu": res}), flush=True)
    assert launched == want and want["flash_fwd"] == 60, res
    assert np.isfinite(l_gpu) and res["loss_rel_diff"] <= STEP_LOSS_REL, res
    assert worst <= STEP_GRAD_REL, res


def cddpm_step_card_vs_cpu(report: dict) -> None:
    """Phase 10e: one cddpm training step (CDDPM_UNET, plain eps-MSE) at
    128², batch 1, on a fixed draw: 4 flash forward, 4 dq and 4 dk/dv
    launches."""
    clean, noisy = _step_batch(70, b=1)
    rng = np.random.default_rng(70)
    t = np.array([29])
    eps = rng.standard_normal(clean.shape).astype(np.float32)
    ah = make_schedule(config.SERVE_SCHEDULE).alpha_hat[t].numpy()[:, None, None, None]
    x_t = (np.sqrt(ah) * clean + np.sqrt(1 - ah) * eps).astype(np.float32)
    n = CDDPM_ATTENTION
    _step_card_vs_cpu(
        "cddpm_step_card_vs_cpu",
        lambda: init_weights(UNetDiffusion(config.CDDPM_UNET), torch.Generator().manual_seed(41)),
        cddpm_loss_fn(), (clean, noisy), (t, x_t, eps),
        {**NO_LAUNCHES, "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}, report)


def tiny_step_card_vs_cpu(report: dict) -> None:
    """Phase 10f: one TinyUNet training step (TINY_UNET, the loss against
    the noise in [-1, 1]) at 128², batch 2, on a fixed draw on the 1000-step
    schedule: no port kernel."""
    clean, noisy = _step_batch(80)
    rng = np.random.default_rng(80)
    t = np.array([17, 801])
    eps = rng.standard_normal(clean.shape).astype(np.float32)
    ah = make_schedule(config.ScheduleConfig(noise_steps=1000)).alpha_hat[t].numpy()[:, None, None, None]
    x_t = (np.sqrt(ah) * (clean * 2 - 1) + np.sqrt(1 - ah) * eps).astype(np.float32)
    _step_card_vs_cpu(
        "tiny_step_card_vs_cpu",
        lambda: init_weights(TinyUNet(config.TINY_UNET), torch.Generator().manual_seed(43)),
        tiny_loss_fn(), (clean, noisy), (t, x_t, eps), NO_LAUNCHES, report)


def write_pairs(root: str, n: int, size: int):
    """n seeded synthetic clean/noisy radiograph pairs as PNG files under
    root/clean and root/noisy (same file names)."""
    dirs = [os.path.join(root, "clean"), os.path.join(root, "noisy")]
    for d in dirs:
        os.makedirs(d)
    for i in range(n):
        png = xray_png(size, size, seed=100 + i)
        clean = np.asarray(Image.open(io.BytesIO(png)), np.float32) / 255
        rng = np.random.default_rng(200 + i)
        noisy = np.clip(clean * (1 + 0.2 * rng.standard_normal(clean.shape)), 0, 1)
        with open(os.path.join(dirs[0], f"xray_{i}.png"), "wb") as f:
            f.write(png)
        Image.fromarray((noisy * 255).astype(np.uint8), mode="L").save(
            os.path.join(dirs[1], f"xray_{i}.png"))
    return dirs


@contextlib.contextmanager
def trainer_probe():
    """While the block runs, every Trainer step is timed and counted, every
    validation counted, and every resume checked against its file
    (``restored_matches``), and the trainer's tp split count
    (``n_sharded``) and row-split parameters (``row_split``) kept, 0
    unsplit. Yields the record."""
    rec = {"steps": [], "vals": [], "resumed": [], "n_sharded": 0, "row_split": 0}
    orig_step, orig_validate, orig_resume = Trainer.train_step, Trainer.validate, Trainer.resume

    def timed_step(self, batch):
        rec["n_sharded"] = 0 if self.shards is None else self.shards.n_sharded
        rec["row_split"] = 0 if self.shards is None else len(self.shards.summed)
        before, t0 = counts(), time.perf_counter()
        loss = orig_step(self, batch)  # returns a host float: the step has finished
        rec["steps"].append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss, "launches": since(before)})
        return loss

    def counted_validate(self, samples):
        before = counts()
        out = orig_validate(self, samples)
        rec["vals"].append(since(before))
        return out

    def checked_resume(self, path):
        orig_resume(self, path)
        rec["resumed"].append(restored_matches(self, path))

    Trainer.train_step, Trainer.validate, Trainer.resume = timed_step, counted_validate, checked_resume
    try:
        yield rec
    finally:
        Trainer.train_step, Trainer.validate, Trainer.resume = orig_step, orig_validate, orig_resume


def restored_matches(trainer, path: str) -> bool:
    """Whether ``trainer`` holds exactly the state that ``path`` saved:
    weights and buffers, AdamW's state, the next epoch, best metrics and
    histories (in the single-process layout: at tp > 1 gathered, so every
    rank of the mesh calls it)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    st = trainer.state
    model, opt = trainer.state_dicts()
    want = ckpt["optimizer_state_dict"]
    return bool(model.keys() == ckpt["model_state_dict"].keys()
                and all(torch.equal(v.cpu(), ckpt["model_state_dict"][k]) for k, v in model.items())
                and opt["param_groups"] == want["param_groups"] and opt["state"].keys() == want["state"].keys()
                and all(torch.equal(v.cpu(), want["state"][i][k]) for i, s in opt["state"].items()
                        for k, v in s.items())
                and st.epoch == ckpt["epoch"] + 1
                and (st.best_psnr, st.best_ssim) == (ckpt["best_psnr"], ckpt["best_ssim"])
                and all(st.history[k] == ckpt[k] for k in st.history))


def recipe_run(cwd: str, argv: list) -> tuple:
    """``recipes.main(argv)`` in the working directory ``cwd`` (the CLI
    writes checkpoints/ and its curves PNG there) under ``trainer_probe``,
    with the counts set to 0 just before. Returns the run's record and the
    TrainerState."""
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with trainer_probe() as rec:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            state = recipes.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launched = counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        os.chdir(here)
    step_ms = [st["ms"] for st in rec["steps"]]
    return {
        "steps": len(step_ms), "losses": [st["loss"] for st in rec["steps"]], "step_ms": step_ms,
        "step_ms_median_after_first": statistics.median(step_ms[1:]) if len(step_ms) > 1 else None,
        "launches_per_step": [st["launches"] for st in rec["steps"]], "validation_launches": rec["vals"],
        "resumed": rec["resumed"], "launches": launched, "wall_s": wall_s, "peak_memory_gib": peak_gib,
        "history": state.history, "n_sharded": rec["n_sharded"], "row_split": rec["row_split"],
    }, state


@contextlib.contextmanager
def cli_run(model: str, n_pairs: int, *extra: str):
    """``recipes.main --model MODEL`` at 512², 1 epoch, on ``n_pairs`` seeded
    synthetic pairs in a temporary working directory, with every Trainer
    step timed and counted and every validation counted. Yields the run's
    record, the TrainerState and the checkpoint directory (deleted on exit)."""
    default_tf32()
    with tempfile.TemporaryDirectory() as tmp:
        clean_dir, noisy_dir = write_pairs(tmp, n_pairs, TRAIN_SIZE)
        run, state = recipe_run(tmp, [
            "--model", model, "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
            "--img-size", str(TRAIN_SIZE), "--epochs", "1", "--max-samples", str(n_pairs), *extra,
        ])
        del run["resumed"]
        yield run, state, os.path.join(tmp, "checkpoints")


def serve_checkpoint(ckpt_dir: str, name: str, per_request: dict = PER_REQUEST) -> tuple:
    """An InferenceEngine on a trained checkpoint answers one 512² request
    with ``per_request`` launches; returns them and the checkpoint's metadata
    as the engine read it."""
    engine = InferenceEngine(EngineConfig(ckpt_dir=ckpt_dir))
    try:
        meta = engine.meta[name]
        assert "demo_weights" not in meta and meta.get("epoch") == 0, meta
        x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 21))), np.float32)[None, :, :, None] / 255
        zero_counts()
        outs = engine.process_all(x, (512, 512))
        served = counts()
    finally:
        engine.close()
    assert all(outs[n] is not None for n in MODEL_NAMES), [n for n in MODEL_NAMES if outs[n] is None]
    assert served == per_request, served
    return served, meta


def moved_tensors(ckpt: dict, fresh: dict) -> int:
    return sum(not torch.equal(fresh[k], v) for k, v in ckpt["model_state_dict"].items())


def train_slice(report: dict, smi: str, keep_dir: str) -> dict:
    """Phase 11a: the diffusion training CLI at full width, then serving what
    it wrote; its ``diffusion.pth`` is copied to ``keep_dir`` for the hybrid
    run. Returns the launches of the training run."""
    try:
        import matplotlib
        plotting = matplotlib.__version__
    except ImportError:
        plotting = None
    with cli_run("diffusion", TRAIN_PAIRS, "--batch-size", "1") as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "diffusion.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(UNetDiffusion(config.SERVE_DIFFUSION),
                             torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        res = {"card": smi, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"]), "matplotlib": plotting}
        report["train_slice"] = res
        print(json.dumps({"train_slice": res}), flush=True)
        assert run["steps"] == TRAIN_PAIRS, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        per_step = {**NO_LAUNCHES, "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}
        assert all(n == per_step for n in run["launches_per_step"]), res
        assert run["validation_launches"] == [{**NO_LAUNCHES, "flash_fwd": 6 * VAL_EVALS}], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "in_channels",
                     "model_channels", "channel_mult", "num_res_blocks", "attention_resolutions",
                     "time_emb_dim", "skip_mode", "noise_steps", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["noise_steps"] == config.SERVE_SCHEDULE.noise_steps and ckpt["epoch"] == 0, ckpt["epoch"]

        served, meta = serve_checkpoint(ckpt_dir, "diffusion")
        shutil.copy(os.path.join(ckpt_dir, "diffusion.pth"), keep_dir)
        report["train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "diffusion", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def nafnet_train_slice(report: dict, smi: str, keep_dir: str) -> dict:
    """Phase 11b: the NAFNet training CLI at full width and its default batch
    of 2, then serving what it wrote; its ``nafnet.pth`` is copied to
    ``keep_dir`` for the hybrid run. Returns the launches of the training
    run."""
    with cli_run("nafnet", NAF_TRAIN_PAIRS) as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "nafnet.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(EnhancedNAFNet(config.SERVE_NAFNET),
                             torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        res = {"card": smi, "batch_size": 2, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"])}
        report["nafnet_train_slice"] = res
        print(json.dumps({"nafnet_train_slice": res}), flush=True)
        assert run["steps"] == NAF_TRAIN_PAIRS // 2, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        per_forward = {**NO_LAUNCHES, "ln2d": 60}  # the backward recomputes the norms in plain ops
        assert all(n == per_forward for n in run["launches_per_step"]), res
        assert run["validation_launches"] == [per_forward], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "img_channel",
                     "width", "middle_blk_num", "enc_blk_nums", "dec_blk_nums", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["width"] == config.SERVE_NAFNET.width and ckpt["epoch"] == 0, ckpt["epoch"]

        served, meta = serve_checkpoint(ckpt_dir, "nafnet")
        shutil.copy(os.path.join(ckpt_dir, "nafnet.pth"), keep_dir)
        report["nafnet_train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "nafnet", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def expert_train_slice(report: dict, smi: str) -> dict:
    """Phase 11c: the expert training CLI at full width and its default batch
    of 4 (no port kernel on its path), then serving what it wrote. Returns
    the launches of the training run."""
    with cli_run("expert", EXPERT_TRAIN_PAIRS) as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "expert.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(ExpertDenoiser(config.SERVE_EXPERT), torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        stats = [k for k in fresh if k.endswith(("running_mean", "running_var"))]
        stats_moved = sum(not torch.equal(fresh[k], ckpt["model_state_dict"][k]) for k in stats)
        res = {"card": smi, "batch_size": 4, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"]), "running_stats_moved": stats_moved,
               "running_stats": len(stats)}
        report["expert_train_slice"] = res
        print(json.dumps({"expert_train_slice": res}), flush=True)
        assert run["steps"] == EXPERT_TRAIN_PAIRS // 4, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        assert all(n == NO_LAUNCHES for n in run["launches_per_step"]), res
        assert run["validation_launches"] == [NO_LAUNCHES], res
        assert moved >= 0.9 * len(fresh) and stats_moved == len(stats) == 26, res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "in_channels",
                     "base_channels", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["base_channels"] == config.SERVE_EXPERT.base_channels and ckpt["epoch"] == 0, ckpt["epoch"]

        served, meta = serve_checkpoint(ckpt_dir, "expert")
        report["expert_train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "expert", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def hybrid_train_slice(report: dict, smi: str, keep_dir: str) -> dict:
    """Phase 11d: the hybrid training CLI at full width and its default batch
    of 6 on the backends that phases 11a and 11b trained (in ``keep_dir``),
    then serving what it wrote beside those backends. Returns the launches
    of the training run."""
    cfg = config.HybridConfig()
    backends = {"nafnet": os.path.join(keep_dir, "nafnet.pth"),
                "diffusion": os.path.join(keep_dir, "diffusion.pth")}
    with cli_run("hybrid", HYBRID_TRAIN_PAIRS, "--nafnet-ckpt", backends["nafnet"],
                 "--diffusion-ckpt", backends["diffusion"]) as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "hybrid.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(RouterFusion(cfg.router, cfg.fusion), torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        per_step = hybrid_step_launches(cfg)
        per_val = {k: HYBRID_VAL_SAMPLES * v for k, v in per_step.items()}  # 10-step rollouts too
        res = {"card": smi, "batch_size": HYBRID_BATCH, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"]), "expected_launches_per_step": per_step}
        report["hybrid_train_slice"] = res
        print(json.dumps({"hybrid_train_slice": res}), flush=True)
        assert run["steps"] == HYBRID_TRAIN_PAIRS // HYBRID_BATCH, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        assert all(n == per_step for n in run["launches_per_step"]), res
        assert run["validation_launches"] == [per_val], res
        assert set(ckpt["model_state_dict"]) == set(fresh), sorted(ckpt["model_state_dict"])
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "nafnet_params",
                     "diffusion_params", "router_params", "fusion_params", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt) and "expert_params" not in ckpt, sorted(ckpt)
        assert ckpt["seeded_backends"] == [], ckpt["seeded_backends"]  # both from phase 11's .pth files
        assert ckpt["diffusion_params"]["noise_steps"] == cfg.schedule.noise_steps and ckpt["epoch"] == 0, ckpt
        assert ckpt["fusion_params"]["sees_expert"] is False, ckpt["fusion_params"]

        for path in backends.values():  # serve it beside the backends it was trained on
            shutil.copy(path, ckpt_dir)
        served, meta = serve_checkpoint(ckpt_dir, "hybrid")
        report["hybrid_train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "hybrid", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def cddpm_train_slice(report: dict, smi: str) -> dict:
    """Phase 11e: the cddpm training CLI at full width and its default batch
    of 1 (4 steps of 4/4/4 flash launches and one ancestral validation
    rollout of 17 evals), then an engine serving its checkpoint as the
    diffusion model (a copy named ``diffusion.pth``). Returns the launches of
    the training run."""
    n = CDDPM_ATTENTION
    with cli_run("cddpm", TRAIN_PAIRS) as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "cddpm.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(UNetDiffusion(config.CDDPM_UNET), torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        res = {"card": smi, "batch_size": 1, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"])}
        report["cddpm_train_slice"] = res
        print(json.dumps({"cddpm_train_slice": res}), flush=True)
        assert run["steps"] == TRAIN_PAIRS, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        per_step = {**NO_LAUNCHES, "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        assert all(k == per_step for k in run["launches_per_step"]), res
        assert run["validation_launches"] == [{**NO_LAUNCHES, "flash_fwd": n * VAL_EVALS}], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "in_channels",
                     "model_channels", "channel_mult", "num_res_blocks", "attention_resolutions",
                     "time_emb_dim", "skip_mode", "noise_steps", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["skip_mode"] == "cddpm" and ckpt["epoch"] == 0, (ckpt["skip_mode"], ckpt["epoch"])

        with tempfile.TemporaryDirectory() as serve_dir:
            shutil.copy(os.path.join(ckpt_dir, "cddpm.pth"), os.path.join(serve_dir, "diffusion.pth"))
            served, meta = serve_checkpoint(serve_dir, "diffusion", CDDPM_PER_REQUEST)
        assert meta["skip_mode"] == "cddpm", meta
        report["cddpm_train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "cddpm as diffusion", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def tiny_train_slice(report: dict, smi: str) -> dict:
    """Phase 11f: the tiny training CLI at full width and its default batch
    of 4 (2 steps and one 12-step DDPM validation rollout, no port kernel),
    then a ``TinyUNetDenoiser`` on its checkpoint denoising one 256² PNG on
    the card. Returns the launches of the training run."""
    with cli_run("tiny", TINY_TRAIN_PAIRS) as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "tiny.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(TinyUNet(config.TINY_UNET), torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        res = {"card": smi, "batch_size": TINY_BATCH, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"])}
        report["tiny_train_slice"] = res
        print(json.dumps({"tiny_train_slice": res}), flush=True)
        assert run["steps"] == TINY_TRAIN_PAIRS // TINY_BATCH, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        assert all(k == NO_LAUNCHES for k in run["launches_per_step"]), res
        assert run["validation_launches"] == [NO_LAUNCHES], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "in_ch", "base_ch",
                     "time_dim", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert (ckpt["in_ch"], ckpt["base_ch"], ckpt["time_dim"]) == (2, 32, 64) and ckpt["epoch"] == 0, ckpt

        denoiser = TinyUNetDenoiser(ckpt["model_state_dict"])
        assert next(denoiser.model.parameters()).is_cuda
        zero_counts()
        t = time.perf_counter()
        img = denoiser.denoise(xray_png(300, 280, 23))
        denoise_ms = (time.perf_counter() - t) * 1e3
        assert counts() == NO_LAUNCHES
        arr = np.asarray(img)
        assert img.mode == "L" and img.size == (256, 256) and 0 < arr.std(), (img.mode, img.size)
        report["tiny_train_slice"]["denoiser"] = {"size": list(img.size), "ms": denoise_ms,
                                                  "mean": float(arr.mean()), "std": float(arr.std())}
        print(json.dumps({"tiny_denoiser": report["tiny_train_slice"]["denoiser"]}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def xray_png(width: int, height: int, seed: int) -> bytes:
    """A smooth synthetic radiograph with grain, seeded."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width] / max(width, height)
    img = 0.3 + 0.4 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.08)
    img += 0.05 * rng.standard_normal((height, width))
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def http_json(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def post_status(addr, png: bytes, size) -> dict:
    """One multipart POST /denoise: its status, Retry-After header, wall ms
    and, unless it answered 200, its body. A 200 must hold four non-null
    PNGs of ``size``."""
    boundary = "smokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
    body += png + f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        t = time.perf_counter()
        conn.request("POST", "/denoise", body, {"Content-Type": f"multipart/form-data; boundary={boundary}"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        ms = (time.perf_counter() - t) * 1e3
    finally:
        conn.close()
    if resp.status == 200:
        for name in MODEL_NAMES:
            assert out.get(name) is not None, f"path {name} answered null"
            img = Image.open(io.BytesIO(base64.b64decode(out[name])))
            assert img.size == size and img.mode == "L", (name, img.size)
    return {"status": resp.status, "retry_after": resp.getheader("Retry-After"), "ms": ms,
            "body": None if resp.status == 200 else out}


def post_denoise(addr, png: bytes, size) -> float:
    """One multipart POST /denoise; checks four non-null PNGs of ``size`` and
    returns the request's wall ms."""
    answer = post_status(addr, png, size)
    assert answer["status"] == 200, answer
    return answer["ms"]


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# each counter's kernels, by the part of their names they share, and their kind
PORT_KINDS = {"ln2d": "ln2d (port kernel)", "naf_ffn": "naf_ffn (port kernel)",
              "flash_fwd": "flash_fwd (port kernel)", "flash_bwd_dq": "flash_bwd dq (port kernel)",
              "flash_bwd_dkv": "flash_bwd dk/dv (port kernel)"}


def _kind(kernel: str) -> str:
    n = kernel.lower()
    for name, kind in PORT_KINDS.items():
        if name in n:
            return kind
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90", "wgrad", "dgrad", "cutlass")):
        return "conv / gemm (cuDNN, cuBLAS)"
    if any(s in n for s in ("norm", "welford", "reduce", "mean")):
        return "norm / reduction"
    if "upsample" in n or "interp" in n:
        return "resize"
    if any(s in n for s in ("memcpy", "memset", "copy")):
        return "copy"
    return "elementwise / other"


def _path_p50_since(engine, marks) -> dict:
    return {n: statistics.median(list(engine.path_ms[n])[marks[n]:]) for n in MODEL_NAMES}


def profile_request(engine, addr) -> dict:
    """``--report`` only: where a 512² request's time goes (see the module
    docstring). Runs after the main path's launch count was read."""
    png = xray_png(512, 512, seed=7)
    x = np.asarray(Image.open(io.BytesIO(png)), np.float32)[None, :, :, None] / 255
    out = {}
    marks = {n: len(engine.path_ms[n]) for n in MODEL_NAMES}
    walls = [post_denoise(addr, png, (512, 512)) for _ in range(PROFILE_REQUESTS)]
    out["http"] = {"wall_ms": walls, "p50_ms": statistics.median(walls),
                   "path_p50_ms": _path_p50_since(engine, marks)}
    marks = {n: len(engine.path_ms[n]) for n in MODEL_NAMES}
    walls = []
    for _ in range(PROFILE_REQUESTS):
        t = time.perf_counter()
        engine.process_all(x, (512, 512))
        walls.append((time.perf_counter() - t) * 1e3)
    out["process_all"] = {"wall_ms": walls, "p50_ms": statistics.median(walls),
                          "path_p50_ms": _path_p50_since(engine, marks)}

    out["paths"] = path_times(engine, x, calls=5)
    wall = sum(p["wall_p50_ms"] for p in out["paths"].values())
    device = sum(p["device_ms"] for p in out["paths"].values())
    out["sum_of_paths"] = {"wall_ms": wall, "device_ms": device, "idle_share": 1.0 - device / wall}

    # the largest GroupNorm input of a 512² UNet eval: 48 channels at full size
    gn = GroupNorm32(8, 48).cuda()
    out["groupnorm_ms"] = {"shape": [1, 48, 512, 512]}
    for dtype in (torch.bfloat16, torch.float32):
        xg = torch.randn(1, 48, 512, 512, device="cuda").to(dtype)
        out["groupnorm_ms"][str(dtype).replace("torch.", "")] = {
            "F.group_norm": time_ms(lambda: F.group_norm(
                xg.float(), 8, gn.weight, gn.bias, gn.eps).to(dtype)),
            "GroupNorm32": time_ms(lambda: gn(xg)),
        }
    out["flash_host_us"] = flash_host_us()
    print(json.dumps({"profile": {"http_p50_ms": out["http"]["p50_ms"],
                                  "process_all_p50_ms": out["process_all"]["p50_ms"],
                                  "sum_of_paths": out["sum_of_paths"],
                                  "groupnorm_ms": out["groupnorm_ms"],
                                  "flash_host_us": out["flash_host_us"]}}), flush=True)
    return out


def flash_host_us(calls: int = 2000) -> dict:
    """Host time per serving call (inference_mode) of the forward through
    ``FlashAttention.apply`` (eager: the wrapper called directly), through
    the custom op ``flash_fwd_op`` (the dispatch a traced graph takes) and of
    ``flash_attention`` called directly, at a shape small enough that the
    host, not the kernel, sets the pace. Median of 5 loops of ``calls``
    calls each, in turns."""
    q = torch.randn(2, 64, 32, device="cuda")
    fns = {"FlashAttention.apply": lambda: fa.FlashAttention.apply(q, q, q),
           "flash_fwd_op": lambda: fa.flash_fwd_op(q, q, q),
           "flash_attention": lambda: fa.flash_attention(q, q, q)}
    times = {name: [] for name in fns}
    with torch.inference_mode():
        for _ in range(5):
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e6 / calls)
    return {"shape": [2, 64, 32], **{name: statistics.median(ts) for name, ts in times.items()}}


def _is_device(evt) -> bool:
    return "cuda" in str(getattr(evt, "device_type", "")).lower()


def _is_launch(evt) -> bool:
    """A host call that launches a kernel (cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel)."""
    return not _is_device(evt) and "launchkernel" in evt.name.lower()


def _profile_events(prof) -> tuple:
    """A profile taken by ``_profile_once``, split at the end of its pad:
    device ms and runs by kernel name of the call's kernels, and how many
    kernels the host launched, in the pad and in the call, that have no
    device record in the profile (matched by CUPTI correlation id)."""
    events = list(prof.events())
    pad_end = max(e.time_range.end for e in events if e.name == PAD_NAME)
    launches = [e for e in events if _is_launch(e)]
    pad_ids = {e.id for e in launches if e.time_range.start < pad_end}
    recorded = {e.id for e in events if _is_device(e)}
    by_kernel, calls = {}, {}
    for evt in events:
        # a user annotation (e.g. Optimizer.step) spans kernels counted on their own
        if not _is_device(evt) or getattr(evt, "is_user_annotation", False) or evt.id in pad_ids:
            continue
        us = _device_us(evt)
        if us > 0:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us / 1e3
            calls[evt.name] = calls.get(evt.name, 0) + 1
    lost = [e.id in pad_ids for e in launches if e.id not in recorded]
    return by_kernel, calls, sum(lost), len(lost) - sum(lost)


def _restore_counts(before: dict) -> None:
    for name, counted in KERNEL_COUNTERS.items():
        counted.launches = before[name]


def device_ms_events(fn, max_cycles: int = 1 << 28) -> tuple:
    """One call of ``fn`` timed by CUDA events while the device is still
    busy with a sleep kernel queued ahead of it, so that the events bracket
    the device's work and not the host's time to enqueue it. Returns (ms,
    hidden): ``hidden`` is whether the sleep was still running when ``fn``
    had been enqueued (the start event not yet reached); if not, the sleep
    is doubled and the call taken again, up to ``max_cycles`` of sleep (the
    default ~0.15 s), after which the time includes host gaps (``fn`` waits
    for the device, for example). Only the first call's launches stay in
    the counts."""
    after_first, cycles = None, 1 << 20
    while True:
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        after_first = after_first or counts()
        if hidden or cycles >= max_cycles:
            break
        cycles *= 2
    _restore_counts(after_first)
    return a.elapsed_time(b), hidden


# torch.profiler (CUPTI) on the H100 machine has come back with no device
# kernel at all, at random points of a run, and then stayed so for the rest
# of the process; device_profile then times by events (device_ms_events). It
# also drops the device records of the first kernels the host launches in a
# profile's window (7-13 of them in runs on an H100, all launched before the
# profile's first device record, more with each later profile; why is not
# known): a NAFNet training step's profile then held 59 of its 60 ln2d runs
# (its first NAFBlock's norm among the lost), and earlier profiles lost
# their first few stock kernels unseen. So each profile first launches
# PAD_KERNELS sleep kernels, for PAD_CYCLES each (~20 ms in all, past the
# ~7 ms of host time the lost launches spanned), and waits for them, inside
# a PAD_NAME annotation; their records, and the loss, fall there and are
# left out. A launch of the call itself with no device record fails the
# profile's cross-check, as does a port kernel with fewer runs than its
# counter saw; device_profile retakes such a profile (``partial_profiles``)
# and keeps, for one that lost a port kernel's run, what it holds around it
# (``PROFILE_DUMPS``, in the report). ``lost_in_pad``: the most pad
# launches one profile lost.
PROFILER = {"profiles": 0, "empty_profiles": 0, "partial_profiles": 0, "event_fallbacks": 0,
            "unhidden_fallbacks": 0, "lost_in_pad": 0, "off": False}
PAD_KERNELS = 256
PAD_CYCLES = 160_000  # ~80 us at the H100's ~1.98 GHz
PAD_NAME = "profile_window_pad"
PROFILE_DUMPS: list = []
# A profile whose device sum is under 1/PARTIAL_FACTOR of the same call's
# time by events, less PARTIAL_SLACK_MS, is taken as partial, where the
# events hid the host (the call does not wait for the device). They then
# bracket the device's work from the call's first kernel to its last and can
# exceed the device sum by the device's own gaps but not fall below it; the
# slack covers the events' overhead (3-4 us measured on 4-6 us kernels). A
# call that waits for the device (a served path, a training step) gets no
# such time: its events hold host gaps (a served diffusion path: 115-193 ms
# by events against 42.5 ms of kernels), and more so where its launches fill
# the device's queue behind the sleep. Its sum is held instead against a
# second profile of the same call. A factor of 2 leaves room for the
# device's gaps and for run-to-run spread, while a profile that lost half of
# its kernels' time or more, as seen (2.18 against 5.85 ms), fails. The
# events take one call behind the shortest sleep (~0.5 ms), not the doubling
# of device_ms_events: a call that waits for the device would otherwise run
# up to 9 more times (a training step, each a real step) before the second
# profile.
PARTIAL_FACTOR = 2.0
PARTIAL_SLACK_MS = 0.01
PROBE_CYCLES = 1 << 20


def _profile_once(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``, after the pad: device ms
    and runs by kernel name, the profile, and how many of the call's
    launches have no device record."""
    from torch.profiler import ProfilerActivity, profile, record_function

    PROFILER["profiles"] += 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PAD_NAME):
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    by_kernel, calls, lost_in_pad, lost = _profile_events(prof)
    PROFILER["lost_in_pad"] = max(PROFILER["lost_in_pad"], lost_in_pad)
    return by_kernel, calls, prof, lost


def _profile_dump(prof, name: str, launched: int) -> dict:
    """What a profile that lost runs of the port kernel ``name`` holds: that
    kernel's runs in start order, the profile's first and last device
    events, and the host's kernel launches (cudaLaunchKernel, cuLaunchKernel)
    whose kernel the profile does not hold, matched by CUPTI correlation
    id. Each event is [start us, duration us, name, correlation id]."""
    events = list(prof.events())
    device = sorted((e for e in events if _is_device(e)), key=lambda e: e.time_range.start)
    ids = {e.id for e in device}
    launches = sorted((e for e in events if _is_launch(e)), key=lambda e: e.time_range.start)
    orphans = [e for e in launches if e.id not in ids]

    def rec(e):
        return [round(e.time_range.start, 1), round(e.time_range.end - e.time_range.start, 1), e.name[:80], e.id]

    runs = [e for e in device if _kind(e.name) == PORT_KINDS[name]]
    host = [e.time_range.start for e in events if not _is_device(e)]
    return {"kernel": name, "launched": launched, "runs_in_profile": len(runs),
            "runs": [rec(e) for e in runs], "device_events": len(device),
            "first_device_events": [rec(e) for e in device[:8]],
            "last_device_events": [rec(e) for e in device[-4:]],
            "host_span_us": [round(min(host), 1), round(max(host), 1)] if host else None,
            "host_launches": len(launches), "host_launches_without_kernel": len(orphans),
            "first_launches_without_kernel": [rec(e) for e in orphans[:20]]}


def _profile_misses(by_kernel: dict, calls: dict, launched: dict, fn, prof, lost: int) -> list:
    """Why a non-empty profile of one call of ``fn`` is partial ([] if it is
    not): ``lost`` launches of the call with no device record, a port
    kernel that the counters saw launched more often than the profile holds
    it (its runs are then dumped into ``PROFILE_DUMPS``), or a device sum
    far under the call's time by events (or, for a call that waits for the
    device, far from a second profile's). The calls made to check leave the
    counts as they were."""
    misses = [f"{lost} launches with no device record"] if lost else []
    for name, n in launched.items():
        runs = {k: c for k, c in calls.items() if _kind(k) == PORT_KINDS[name]}
        if sum(runs.values()) < n:
            misses.append(f"{name}: {n} launched, {sum(runs.values())} in the profile: {runs}")
            dump = _profile_dump(prof, name, n)
            PROFILE_DUMPS.append(dump)
            print(json.dumps({"profile_dump": {k: dump[k] for k in (
                "kernel", "launched", "runs_in_profile", "host_launches_without_kernel",
                "first_launches_without_kernel", "first_device_events")}}), flush=True)
    before = counts()
    events_ms, hidden = device_ms_events(fn, max_cycles=PROBE_CYCLES)
    device = sum(by_kernel.values())
    if hidden:
        if device * PARTIAL_FACTOR < events_ms - PARTIAL_SLACK_MS:
            misses.append(f"device sum {device:.4f} ms against {events_ms:.4f} ms by events")
    else:
        second = sum(_profile_once(fn)[0].values())
        if max(device, second) > PARTIAL_FACTOR * min(device, second):
            misses.append(f"device sum {device:.4f} ms against {second:.4f} ms in a second profile")
    _restore_counts(before)
    return misses


def device_profile(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``: device ms by kernel, and
    by kernel kind (largest first). A profile that recorded no device kernel,
    or that fails the cross-check of ``_profile_misses``, is taken again, up
    to 3 times, and the launches of a discarded call are taken back from the
    counts. If all 3 come back empty, the profiler is off for the rest of the
    run, and this and every later call is timed by ``device_ms_events`` as
    one entry, not split by kernel (counted in ``PROFILER``); if they came
    back partial, this call alone is timed so."""
    by_kernel, misses = {}, []
    for _ in range(0 if PROFILER["off"] else 3):
        before = counts()
        by_kernel, calls, prof, lost = _profile_once(fn)
        launched = since(before)
        if by_kernel:
            misses = _profile_misses(by_kernel, calls, launched, fn, prof, lost)
            if not misses:
                break
            PROFILER["partial_profiles"] += 1
            print(json.dumps({"partial_profile": misses}), flush=True)
        else:
            PROFILER["empty_profiles"] += 1
        _restore_counts(before)
    if not by_kernel or misses:
        PROFILER["off"] = PROFILER["off"] or not by_kernel
        ms, hidden = device_ms_events(fn)
        PROFILER["event_fallbacks"] += 1
        PROFILER["unhidden_fallbacks"] += not hidden
        how = "host gaps included" if not hidden else "host hidden"
        why = "profiler off" if PROFILER["off"] else "3 partial profiles"
        by_kernel = {f"all kernels: CUDA events after a sleep kernel, {how} ({why})": ms}
        return by_kernel, {f"not split: {why}": ms}
    kinds = {}
    for k, ms in by_kernel.items():
        kinds[_kind(k)] = kinds.get(_kind(k), 0.0) + ms
    return by_kernel, dict(sorted(kinds.items(), key=lambda kv: -kv[1]))


def profile_train_step(model: str) -> dict:
    """``--report`` only: where a full-width training step's time goes. One
    Trainer step at 512², fp32 (torch's TF32 defaults, as the CLI runs), at
    the CLI's defaults: SERVE_DIFFUSION at batch 1, SERVE_NAFNET (the
    reference CombinedLoss) at batch 2, SERVE_EXPERT (HybridLoss) at batch
    4, the HybridConfig() router and fusion on seeded frozen backends
    (PerceptualLoss) at batch 6, CDDPM_UNET (eps-MSE) at batch 1 or
    TINY_UNET (the loss against the noise) at batch 4, on a batch made as the CLI makes its
    batches (``to_device`` of NHWC arrays, so the activations are
    channels-last). Wall time (median of 5 after 2 warm-up steps) and peak
    memory beside the device time of one further step under
    ``torch.profiler``, by kernel kind."""
    default_tf32()
    x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 31))), np.float32) / 255
    cfg = recipes.default_train_config(model)
    gen = torch.Generator().manual_seed(0)
    if model == "diffusion":
        sched = make_schedule(config.SERVE_SCHEDULE, "cuda")
        trainer = Trainer(diffusion_loss_fn(sched), None, cfg,
                          init_weights(UNetDiffusion(config.SERVE_DIFFUSION), gen),
                          diffusion_draw(sched), device="cuda")
    elif model == "nafnet":
        trainer = Trainer(nafnet_loss_fn(), None, cfg, perturbed_nafnet(0), no_draw, device="cuda")
    elif model == "expert":
        trainer = Trainer(expert_loss_fn(), None, cfg, init_weights(ExpertDenoiser(config.SERVE_EXPERT), gen),
                          no_draw, has_batch_stats=True, device="cuda")
    elif model == "cddpm":
        sched = make_schedule(config.SERVE_SCHEDULE, "cuda")
        trainer = Trainer(cddpm_loss_fn(), None, cfg,
                          init_weights(UNetDiffusion(config.CDDPM_UNET), gen),
                          diffusion_draw(sched), device="cuda")
    elif model == "tiny":
        trainer = Trainer(tiny_loss_fn(), None, cfg, init_weights(TinyUNet(config.TINY_UNET), gen),
                          tiny_draw(make_schedule(config.ScheduleConfig(noise_steps=1000), "cuda")),
                          device="cuda")
    else:
        hc = config.HybridConfig()
        trainer = Trainer(hybrid_loss_fn(make_schedule(hc.schedule, "cuda"), hc.training_diffusion_steps),
                          None, cfg, init_weights(RouterFusion(hc.router, hc.fusion), gen), no_draw,
                          frozen=hybrid_frozen(0), device="cuda")
    nhwc = np.broadcast_to(x[None, :, :, None], (cfg.batch_size, *x.shape, 1))
    batch = to_device((nhwc, 0.9 * nhwc), torch.device("cuda"))
    out = _profile_step("train_step_profile", lambda: trainer.train_step(batch), model=model,
                        batch_size=cfg.batch_size)
    del trainer
    torch.cuda.empty_cache()
    return out


def profile_bench_step(model: str) -> dict:
    """``--report`` only: where a ``bench_train_torch.py --quick`` step's time
    goes: its step (bf16 compute, fp32 AdamW) at its quick cell (256², batch
    2) on seeded batches, profiled as ``profile_train_step`` profiles."""
    default_tf32()
    dev = torch.device("cuda")
    step = bench_train_torch.make_step(model, dev)
    (img, b), = bench_train_torch.QUICK[model]
    gen = torch.Generator().manual_seed(32)
    clean = torch.rand(b, 1, img, img, generator=gen).to(dev)
    noisy = (clean + 0.1 * torch.randn(b, 1, img, img, generator=gen).to(dev)).clamp(0, 1)
    out = _profile_step("bench_step_profile", lambda: step(clean, noisy), model=model, batch_size=b, img=img)
    del step
    torch.cuda.empty_cache()
    return out


def _profile_step(name: str, step, **fields) -> dict:
    """Wall ms of ``step`` (median of 5 after 2 warm-up calls, each ended by a
    synchronise) and peak memory beside the device time of one further call
    under ``torch.profiler``, by kernel kind; printed on a ``name`` line."""
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    zero_counts()
    by_kernel, kinds = device_profile(step)
    launched = counts()
    wall, device = statistics.median(walls), sum(by_kernel.values())
    out = {**fields, "wall_ms": walls, "wall_p50_ms": wall, "device_ms": device,
           "idle_share": 1.0 - device / wall, "launches": launched,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "device_ms_by_kind": kinds,
           "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]}
    print(json.dumps({name: {k: out[k] for k in ("model", "wall_p50_ms", "device_ms", "idle_share",
                                                 "peak_memory_gib", "device_ms_by_kind")}}), flush=True)
    return out


def serve_slice(report: dict, profile: bool) -> dict:
    """Phase 8: full-width serving through the port's server; returns the
    kernel launches of the requests."""
    default_tf32()
    t = time.time()
    engine = InferenceEngine(EngineConfig())
    report["engine_build_s"] = time.time() - t
    mode = engine.serving_mode()
    assert mode["img_size"] == 512 and mode["steps"] == [8, 8], mode
    assert mode["diffusion_eps"] == [0, 2, 6, 7] and mode["hybrid_eps"] == [0, 2, 6, 7], mode
    srv = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    try:
        status, body = http_json(addr, "GET", "/")
        assert status == 200 and body["status"] == "running", body
        status, body = http_json(addr, "GET", "/health")
        assert status == 200 and body["models_loaded"] == {n: True for n in MODEL_NAMES}, body
        print(json.dumps({"health": body}), flush=True)

        sizes = [(600, 500), (512, 512), (333, 421)]
        latencies, per_request = [], []
        zero_counts()
        for i, size in enumerate(sizes):
            before = counts()
            latencies.append(post_denoise(addr, xray_png(*size, seed=i), size))
            per_request.append(since(before))
            assert per_request[-1] == PER_REQUEST, f"request {i}: {per_request[-1]} launches"
        launches = counts()
        report["path_ms"] = {n: list(engine.path_ms[n]) for n in MODEL_NAMES}
        if profile:
            report["profile"] = profile_request(engine, addr)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 9))), np.float32)[None, :, :, None] / 255
    for name in MODEL_NAMES:
        y = engine.fns[name](x)
        assert y.shape == (1, 512, 512, 1) and np.isfinite(y).all(), name
        assert y.min() >= 0.0 and y.max() <= 1.0, name
    report["request_ms"] = latencies
    report["request_p50_ms"] = statistics.median(latencies)
    report["launches_per_request"] = per_request
    print(json.dumps({"request_ms": latencies, "request_p50_ms": report["request_p50_ms"],
                      "path_ms": report["path_ms"],
                      "launches_per_request": per_request}), flush=True)
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def serving(engine):
    """The port's server around ``engine`` on a free port; yields its address
    and stops it on leaving."""
    srv = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def client_load(addr, pngs_per_client: list, size) -> dict:
    """Clients that start at once, each posting its PNGs in turn (a closed
    loop); request rate, wall p50 and p95 of the answered requests."""
    def client(pngs):
        return [post_status(addr, png, size) for png in pngs]

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(pngs_per_client)) as pool:
        answers = [a for per_client in pool.map(client, pngs_per_client) for a in per_client]
    wall = time.perf_counter() - t
    ms = [a["ms"] for a in answers if a["status"] == 200]
    return {"answers": answers, "wall_s": wall, "n": len(answers), "n_ok": len(ms),
            "req_per_s": len(ms) / wall, "p50_ms": statistics.median(ms),
            "p95_ms": float(np.percentile(ms, 95))}


def _load_summary(load: dict, stats: dict, wait_ms) -> dict:
    return {**{k: v for k, v in load.items() if k != "answers"}, **stats,
            "mean_batch": stats["requests"] / max(stats["batches"], 1),
            "queue_wait_p50_ms": statistics.median(wait_ms) if wait_ms else None}


def _png_array(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)), np.float32)[None, :, :, None] / 255


def _launches(flash_fwd: int = 0, ln2d: int = 0) -> dict:
    return {**NO_LAUNCHES, "flash_fwd": flash_fwd, "ln2d": ln2d}


def batched_serving(report: dict) -> dict:
    """Phase 8b (a): 8 clients x 2 distinct 256² requests through a batching
    server (auto buckets (1, 2, 4, 8)); one launch of each kernel serves a
    whole batch. Then an exact engine's bucket-8 batch against each image
    served alone. Returns the requests' launches."""
    default_tf32()
    engine = InferenceEngine(EngineConfig(img_size=256, batching=True))
    try:
        assert engine.batcher.buckets == [1, 2, 4, 8], engine.batcher.buckets
        assert engine.serving_mode()["batching"] is True
        pngs = [[xray_png(256, 256, seed=1000 + 10 * c + r) for r in range(BATCH_REQUESTS)]
                for c in range(BATCH_CLIENTS)]
        with serving(engine) as addr:
            zero_counts()
            load = client_load(addr, pngs, (256, 256))
            launched = counts()
        stats = engine.batcher.stats
        summary = _load_summary(load, stats, list(engine.batcher.wait_ms))
    finally:
        engine.close()
    report["serve_batched"] = summary
    print(json.dumps({"serve_batched": summary}), flush=True)
    assert all(a["status"] == 200 for a in load["answers"]), load["answers"]
    assert stats["requests"] == BATCH_CLIENTS * BATCH_REQUESTS, stats
    assert stats["batches"] < stats["requests"] and stats["max_batch"] > 1, stats
    assert launched == _launches(48 * stats["batches"], 120 * stats["batches"]), launched

    # exact fp32 (TF32 off): a bucket-8 batch against each image served alone
    set_tf32(False)
    exact = InferenceEngine(EngineConfig(img_size=256, batching=True, warmup=False, batch_max_wait_ms=500.0,
                                         turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1,
                                         diffusion_eval_bf16=False, hybrid_rollout_bf16=False))
    try:
        xs = [_png_array(xray_png(256, 256, seed=1100 + i)) for i in range(SERVE_BUCKET)]
        futs = [exact.batcher.submit(x) for x in xs]
        outs = [f.result(timeout=600) for f in futs]
        stats = exact.batcher.stats
        err = max(float(np.abs(out[name] - exact.fns[name](x)).max())
                  for x, out in zip(xs, outs) for name in MODEL_NAMES)
    finally:
        exact.close()
    report["serve_batched"]["exact_bucket8_vs_single"] = {"max_abs_diff": err, "bound": BATCH_VS_SINGLE_BOUND,
                                                          "batches": stats["batches"]}
    print(json.dumps({"exact_bucket8_vs_single": report["serve_batched"]["exact_bucket8_vs_single"]}),
          flush=True)
    assert stats["batches"] == 1 and stats["max_batch"] == SERVE_BUCKET, stats
    assert err <= BATCH_VS_SINGLE_BOUND, f"a batch of 8 differs from its images served alone by {err}"
    return launched


def adaptive_serving(report: dict) -> dict:
    """Phase 8b (b): 12 clients at once at 512², buckets (1,), adaptive turbo
    from a queue of 3, admission bounded at 6 waiting requests, and fused
    requests: with seeded demo weights the hybrid has its own backends, so
    an exact batch's fused call makes the per-path launches (a turbo batch
    runs the per-path functions)."""
    default_tf32()
    engine = InferenceEngine(EngineConfig(batching=True, adaptive_turbo=True, adaptive_queue_depth=3,
                                          max_queue_depth=ADAPTIVE_MAX_QUEUE, fused_request=True))
    try:
        assert engine.batcher.buckets == [1] and set(engine.turbo_fns) == {"diffusion", "hybrid"}
        assert engine.shares == {"backends": False, "rollout": False}, engine.shares
        pngs = [[xray_png(512, 512, seed=2000 + c)] for c in range(ADAPTIVE_CLIENTS)]
        with serving(engine) as addr:
            zero_counts()
            load = client_load(addr, pngs, (512, 512))
            launched = counts()
        stats = engine.batcher.stats
        summary = _load_summary(load, stats, list(engine.batcher.wait_ms))
    finally:
        engine.close()
    report["serve_adaptive"] = summary
    print(json.dumps({"serve_adaptive": summary}), flush=True)
    refused = [a for a in load["answers"] if a["status"] == 503]
    assert all(a["status"] in (200, 503) for a in load["answers"]), load["answers"]
    assert all(a["retry_after"] == "1" and "detail" in a["body"] for a in refused), refused
    assert len(refused) == stats["rejected"] and stats["requests"] == load["n_ok"], (len(refused), stats)
    turbo, exact = stats["turbo_batches"], stats["batches"] - stats["turbo_batches"]
    assert turbo > 0 and exact > 0 and stats["fused_failures"] == 0, stats
    # a turbo batch: both rollouts at (0, 2, 7), 3 evals x 6 blocks each
    assert launched == _launches(48 * exact + 36 * turbo, 120 * stats["batches"]), launched
    return launched


def fused_serving(report: dict, profile: bool) -> dict:
    """Phase 8b (c): fused requests at 512² on a hybrid checkpoint of router
    and fusion alone, so the NAFNet forward and the rollout are shared; and
    GET /ui."""
    default_tf32()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        rf = init_weights(RouterFusion(), torch.Generator().manual_seed(11))
        torch.save({"model_state_dict": rf.state_dict(), "epoch": 0}, os.path.join(ckpt_dir, "hybrid.pth"))
        engine = InferenceEngine(EngineConfig(ckpt_dir=ckpt_dir, fused_request=True))
    try:
        assert engine.shares == {"backends": True, "rollout": True}, engine.shares
        assert engine.serving_mode()["fused_request"] is True
        with serving(engine) as addr:
            conn = http.client.HTTPConnection(*addr, timeout=60)
            conn.request("GET", "/ui")
            resp = conn.getresponse()
            page = resp.read()
            conn.close()
            assert resp.status == 200 and resp.getheader("Content-Type").startswith("text/html"), resp.status
            assert b"/denoise" in page
            per_request, walls = [], []
            zero_counts()
            for i in range(FUSED_REQUESTS):
                before = counts()
                walls.append(post_denoise(addr, xray_png(512, 512, seed=3000 + i), (512, 512)))
                per_request.append(since(before))
            launched = counts()
        assert all(r == _launches(24, 60) for r in per_request), per_request
        assert engine.fused_failures == 0, engine.fused_failures
        x = _png_array(xray_png(512, 512, seed=3100))
        fused = engine.fused(x)
        err = max(float(np.abs(fused[name] - engine.fns[name](x)).max()) for name in MODEL_NAMES)
        summary = {"request_ms": walls, "launches_per_request": per_request[0],
                   "fused_vs_per_path_max_abs_diff": err, "bound": FUSED_BOUND,
                   "fused_failures": engine.fused_failures}
        if profile:
            summary["device"] = {}
            for key, fn in (("fused", lambda: engine.fused(x)),
                            ("per_path", lambda: engine._on_device_thread(engine._run_all, x))):
                wall = []
                for _ in range(5):
                    t = time.perf_counter()
                    fn()
                    wall.append((time.perf_counter() - t) * 1e3)
                by_kernel, kinds = device_profile(fn)
                summary["device"][key] = {"wall_p50_ms": statistics.median(wall),
                                          "device_ms": sum(by_kernel.values()), "device_ms_by_kind": kinds}
    finally:
        engine.close()
    report["serve_fused"] = summary
    print(json.dumps({"serve_fused": summary}), flush=True)
    assert err <= FUSED_BOUND, f"fused outputs differ from the per-path ones by {err}"
    return launched


def cli_slice(report: dict) -> dict:
    """Phase 8b (d): the inference CLI with TTA on one 512² PNG (4 NAFNet
    forwards) and ``evaluate`` of the hybrid over 4 seeded 512² pairs
    (reference-exact: 9 fp32 UNet evals an image)."""
    with tempfile.TemporaryDirectory() as root:
        none = os.path.join(root, "no_checkpoints")  # seeded demo weights
        src, out = os.path.join(root, "x.png"), os.path.join(root, "out.png")
        with open(src, "wb") as f:
            f.write(xray_png(512, 512, seed=4000))
        zero_counts()
        inference.main(["--model", "nafnet", "--image", src, "--out", out, "--tta", "--ckpt-dir", none])
        inferred = counts()
        assert Image.open(out).size == (512, 512)
        for sub in ("clean", "noisy"):
            os.makedirs(os.path.join(root, sub))
        for i in range(CLI_PAIRS):
            clean = _png_array(xray_png(512, 512, seed=4100 + i))[0, :, :, 0]
            noisy = clean + 0.05 * np.random.default_rng(4200 + i).standard_normal(clean.shape)
            for sub, arr in (("clean", clean), ("noisy", noisy)):
                Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8), mode="L").save(
                    os.path.join(root, sub, f"img{i}.png"))
        result = evaluate.main(["--model", "hybrid", "--clear-dir", os.path.join(root, "clean"),
                                "--noisy-dirs", os.path.join(root, "noisy"), "--ckpt-dir", none])
        launched = counts()
    evaluated = {k: launched[k] - inferred[k] for k in launched}
    report["cli"] = {"inference_launches": inferred, "evaluate_launches": evaluated, "evaluate": result}
    print(json.dumps({"cli": report["cli"]}), flush=True)
    assert inferred == _launches(0, 4 * 60), inferred
    steps = len(timestep_sequence(config.SERVE_SCHEDULE.noise_steps, 8))
    assert evaluated == _launches(CLI_PAIRS * steps * 6, CLI_PAIRS * 60), evaluated
    assert result["n"] == CLI_PAIRS and np.isfinite(result["psnr"]) and np.isfinite(result["ssim"]), result
    return launched


def batching_report() -> dict:
    """``--report`` only: request rate and wall p50 / p95 under 8 closed-loop
    clients, each bucket set against the other in turns (A, B, B, A): 256²
    with buckets (1,) and (1, 2, 4, 8), 512² with (1,) and (1, 2)."""
    default_tf32()
    out = {}
    for size, a, b in ((256, (1,), (1, 2, 4, 8)), (512, (1,), (1, 2))):
        for turn, buckets in enumerate((a, b, b, a)):
            engine = InferenceEngine(EngineConfig(img_size=size, batching=True, batch_buckets=buckets))
            try:
                pngs = [[xray_png(size, size, seed=5000 + 100 * turn + 10 * c + r) for r in range(REPORT_REQUESTS)]
                        for c in range(REPORT_CLIENTS)]
                with serving(engine) as addr:
                    load = client_load(addr, pngs, (size, size))
                summary = _load_summary(load, engine.batcher.stats, list(engine.batcher.wait_ms))
            finally:
                engine.close()
            assert load["n_ok"] == load["n"], load["answers"]
            key = f"{size}_buckets_{'-'.join(map(str, buckets))}"
            out.setdefault(key, []).append(summary)
            print(json.dumps({"batching_report": key, **summary}), flush=True)
    return out


def card_vs_cpu(report: dict) -> None:
    """Phase 9a: one exact fp32 diffusion rollout at 256² on the card and on
    the CPU, same seeded demo weights and input."""
    set_tf32(False)
    kw = dict(img_size=256, warmup=False, turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1,
              diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
    x = np.asarray(Image.open(io.BytesIO(xray_png(256, 256, 3))), np.float32)[None, :, :, None] / 255

    def side(dev):
        engine = InferenceEngine(EngineConfig(**kw, device=dev))
        try:
            zero_counts()
            return engine.fns["diffusion"](x), counts()["flash_fwd"]
        finally:
            engine.close()

    out = on_devices("card_vs_cpu", side)
    (gpu, launches), (cpu, _) = out["cuda"], out["cpu"]
    diff = float(np.abs(gpu - cpu).max())
    report["card_vs_cpu"] = {"max_abs_diff": diff, "bound": CARD_VS_CPU_BOUND,
                             "flash_launches": launches}
    print(json.dumps({"card_vs_cpu": report["card_vs_cpu"]}), flush=True)
    assert np.isfinite(gpu).all() and gpu.shape == (1, 256, 256, 1)
    assert launches == 9 * 6, launches
    assert diff <= CARD_VS_CPU_BOUND, f"card vs CPU rollout differs by {diff}"


def _seeded_image(size: int, seed: int) -> torch.Tensor:
    """A seeded 1x1xHxW radiograph in [0, 1], fp32, on the CPU."""
    x = np.asarray(Image.open(io.BytesIO(xray_png(size, size, seed))), np.float32) / 255
    return torch.from_numpy(x)[None, None]


def cddpm_rollout_card_vs_cpu(report: dict) -> None:
    """Phase 9c: one CDDPM_UNET ancestral rollout at 256², fp32 (8 inference
    steps: 9 scan steps, no eps clamp, 0.5-scaled posterior noise), on the
    card and on the CPU, same seeded weights, input and ``noise_seq`` (the
    two devices' generators draw differently, so nothing else compares)."""
    set_tf32(False)
    x = _seeded_image(256, 5)
    n_steps = len(timestep_sequence(config.SERVE_SCHEDULE.noise_steps, 8))
    seq = torch.randn((n_steps, *x.shape), generator=torch.Generator().manual_seed(8))

    def side(dev):
        model = init_weights(UNetDiffusion(config.CDDPM_UNET), torch.Generator().manual_seed(3)).to(dev).eval()
        with torch.inference_mode():
            zero_counts()
            return denoise(model, x.to(dev), make_schedule(config.SERVE_SCHEDULE, dev), 8,
                           stochastic=True, clamp_eps=False, noise_seq=seq.to(dev)).cpu(), counts()

    both = on_devices("cddpm_rollout_card_vs_cpu", side)
    outs, card_launches = {dev: out for dev, (out, _) in both.items()}, both["cuda"][1]
    diff = (outs["cuda"] - outs["cpu"]).abs().max().item()
    res = {"max_abs_diff": diff, "bound": CARD_VS_CPU_BOUND, "scan_steps": n_steps, "launches": card_launches}
    report["cddpm_rollout_card_vs_cpu"] = res
    print(json.dumps({"cddpm_rollout_card_vs_cpu": res}), flush=True)
    assert card_launches == {**NO_LAUNCHES, "flash_fwd": CDDPM_ATTENTION * n_steps}, res
    assert torch.isfinite(outs["cuda"]).all() and outs["cuda"].shape == x.shape
    assert diff <= CARD_VS_CPU_BOUND, res


def tiny_sample_card_vs_cpu(report: dict) -> None:
    """Phase 9d: one 12-step ``DDPMScheduler.sample`` of a seeded TINY_UNET
    at 256², fp32, from the image in [-1, 1], on the card and on the CPU with
    one shared ``noise_seq``; no port kernel runs."""
    set_tf32(False)
    cond = _seeded_image(256, 6) * 2 - 1
    seq = torch.randn((TINY_STEPS, *cond.shape), generator=torch.Generator().manual_seed(9))

    def side(dev):
        model = init_weights(TinyUNet(config.TINY_UNET), torch.Generator().manual_seed(4)).to(dev).eval()
        with torch.inference_mode():
            zero_counts()
            return DDPMScheduler().sample(model, cond.to(dev), TINY_STEPS, noise_seq=seq.to(dev)).cpu(), counts()

    both = on_devices("tiny_sample_card_vs_cpu", side)
    outs, card_launches = {dev: out for dev, (out, _) in both.items()}, both["cuda"][1]
    diff = (outs["cuda"] - outs["cpu"]).abs().max().item()
    res = {"max_abs_diff": diff, "bound": CARD_VS_CPU_BOUND, "steps": TINY_STEPS, "launches": card_launches}
    report["tiny_sample_card_vs_cpu"] = res
    print(json.dumps({"tiny_sample_card_vs_cpu": res}), flush=True)
    assert card_launches == NO_LAUNCHES, res
    assert torch.isfinite(outs["cuda"]).all() and outs["cuda"].shape == cond.shape
    assert diff <= CARD_VS_CPU_BOUND, res


# -- phases 12-14: int8 serving, the 1024² operating point, MODEL2_NAFNET ----------


def path_times(engine, x: np.ndarray, names=MODEL_NAMES, calls: int = 3) -> dict:
    """Per path: wall p50 of ``calls`` calls, one call's device time under the
    profiler (by kind, and its largest kernels), the idle share, the
    launches of that call and its peak device memory."""
    out = {}
    for name in names:
        fn = engine.fns[name]
        walls = []
        for _ in range(calls):
            t = time.perf_counter()
            fn(x)
            walls.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        by_kernel, kinds = device_profile(lambda: fn(x))
        wall, device = statistics.median(walls), sum(by_kernel.values())
        out[name] = {"wall_ms": walls, "wall_p50_ms": wall, "device_ms": device, "idle_share": 1.0 - device / wall,
                     "launches": since(before), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "device_ms_by_kind": kinds,
                     "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]}
    return out


def int8_conv_shapes(batch: int, size: int = config.SERVE_IMG_SIZE) -> list:
    """(input shape, out channels, kernel, stride) of each int8 conv call of
    SERVE_DIFFUSION at ``size``², found by one forward with hooks on the
    card; and the number of int8 convs a forward runs."""
    unet = init_weights(UNetDiffusion(config.SERVE_DIFFUSION, quant="dynamic"),
                        torch.Generator().manual_seed(0)).cuda().eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((tuple(a[0].shape), m.out_channels, m.kernel_size[0], m.stride[0])))
        for m in unet.modules() if isinstance(m, qconv.QuantConv2d)]
    x = torch.rand(batch, 1, size, size, device="cuda")
    with torch.inference_mode():
        unet(x, x, torch.zeros(batch, dtype=torch.long, device="cuda"))
    for hook in hooks:
        hook.remove()
    assert len(seen) == len(hooks), (len(seen), len(hooks))
    return sorted(set(seen)), len(hooks)


def int8_products(report: dict) -> int:
    """Phase 12a: the card's int32 product against the plain one (float64 on
    the card) at every int8 conv shape of SERVE_DIFFUSION at 512², batch 1
    and 2, bit for bit; timed at batch 1 beside cuDNN's convolution of the
    same shape in bf16 and fp32 (TF32 on, the server's default). Returns the
    number of int8 convs in one UNet forward."""
    default_tf32()
    gen = torch.Generator().manual_seed(12)
    rows = []
    for batch in (1, 2):
        shapes, per_forward = int8_conv_shapes(batch)
        for (b, c, h, w), o, k, stride in shapes:
            xq = torch.randint(-127, 128, (b, c, h, w), generator=gen, dtype=torch.int8).cuda()
            wq = torch.randint(-127, 128, (o, c, k, k), generator=gen, dtype=torch.int8).cuda()
            got = qconv.int8_conv2d(xq, wq, stride, k // 2)
            want = qconv.int8_conv2d_plain(xq, wq, stride, k // 2)
            row = {"shape": [b, c, h, w], "out": o, "k": k, "stride": stride,
                   "bitwise_equal": bool(torch.equal(got, want)), "dtype": str(got.dtype)}
            if b == 1:
                xf, wf = xq.float(), wq.float()
                xb, wb = xf.bfloat16(), wf.bfloat16()
                row.update({
                    "int8_ms": time_ms(lambda: qconv.int8_conv2d(xq, wq, stride, k // 2), reps=10),
                    "cudnn_bf16_ms": time_ms(lambda: F.conv2d(xb, wb, None, stride, k // 2), reps=10),
                    "cudnn_fp32_ms": time_ms(lambda: F.conv2d(xf, wf, None, stride, k // 2), reps=10),
                })
            rows.append(row)
            if not (row["bitwise_equal"] and got.dtype == torch.int32):
                raise AssertionError(f"int8 product differs from its plain version: {row}")
    timed = [r for r in rows if "int8_ms" in r]
    summary = {"shapes": len(rows), "int8_convs_per_forward": per_forward,
               "sum_ms_batch1": {k: sum(r[k] for r in timed) for k in ("int8_ms", "cudnn_bf16_ms", "cudnn_fp32_ms")}}
    report["int8_products"] = {"cases": rows, **summary}
    print(json.dumps({"int8_products": summary}), flush=True)
    return per_forward


def int8_serving(report: dict, per_forward: int) -> dict:
    """Phase 12b: the server's ``--int8`` configuration at 512² (static
    scales calibrated at startup) behind the stdlib server: 3 requests, four
    PNGs each, 48 flash forward and 120 ln2d launches and 8 UNet evals' int8
    products a request; then the rollout paths' wall and device time against
    a default (fp32-weight convolutions) engine on the same image, and
    max|int8 - fp32| per path as information. Returns the requests'
    launches and the engine's calibrated scales, which the run's later int8
    engines serve (one calibration a run)."""
    default_tf32()
    _, cfg = server.config_from_args(["--int8"])
    assert cfg.quantize_int8 == "static", cfg
    t = time.time()
    engine = InferenceEngine(cfg)
    build_s = time.time() - t
    try:
        mode = engine.serving_mode()
        assert mode["quantize_int8"] == "static" and mode["exact"] is False, mode
        assert set(engine.calibration_ms) == {"diffusion", "hybrid"}, engine.calibration_ms
        with serving(engine) as addr:
            status, body = http_json(addr, "GET", "/health")
            assert status == 200 and body["serving_mode"]["quantize_int8"] == "static", body
            per_request, walls = [], []
            zero_counts()
            calls = qconv.int8_conv2d.calls
            for i in range(INT8_REQUESTS):
                before = counts()
                walls.append(post_denoise(addr, xray_png(512, 512, seed=4000 + i), (512, 512)))
                per_request.append(since(before))
            launched = counts()
            int8_calls = qconv.int8_conv2d.calls - calls
        assert all(r == PER_REQUEST for r in per_request), per_request
        assert int8_calls == INT8_REQUESTS * INT8_EVALS_PER_REQUEST * per_forward, int8_calls
        x = _png_array(xray_png(512, 512, seed=4100))
        reference = InferenceEngine(EngineConfig())
        try:
            diff = {n: float(np.abs(engine.fns[n](x) - reference.fns[n](x)).max()) for n in MODEL_NAMES}
            times = {"int8": path_times(engine, x, ("diffusion", "hybrid")),
                     "fp32_weights": path_times(reference, x, ("diffusion", "hybrid"))}
        finally:
            reference.close()
    finally:
        engine.close()
    summary = {"engine_build_s": build_s, "calibration_ms": engine.calibration_ms, "request_ms": walls,
               "launches_per_request": per_request[0], "int8_products_per_request": int8_calls // INT8_REQUESTS,
               "max_abs_int8_minus_fp32": diff, "paths": times}
    report["serve_int8"] = summary
    print(json.dumps({"serve_int8": {k: v for k, v in summary.items() if k != "paths"}}), flush=True)
    print(json.dumps({"serve_int8_paths": {e: {n: {k: p[k] for k in ("wall_p50_ms", "device_ms", "idle_share")}
                                               for n, p in paths.items()} for e, paths in times.items()}}),
          flush=True)
    return launched, engine.int8_scales


def int8_card_vs_cpu(report: dict) -> None:
    """Phase 12c: static int8 on both devices, SERVE_DIFFUSION on the same
    seeded weights, fp32 with TF32 off: the calibration on the engine's
    phantom set at 128² (2-step rollouts, the first noise family) on the
    card against the CPU's (each act_absmax to INT8_ABSMAX_REL); then, with the CPU's scales
    loaded on both, one int8 UNet eval and one 128² int8 rollout (8 served
    steps, exact) on each device. For scale, the CPU's eval and rollout are
    also taken with its attention through the flash kernel's plain version:
    the same exact function summed in another order (the ``cpu_spread``);
    the card must stay within INT8_SPREAD_RATIO of it on the mean. The CPU
    half needs nothing of the card's, so it runs while the kernels build."""
    set_tf32(False)
    size, steps, batches = CALIBRATION_CHECK
    base = init_weights(UNetDiffusion(config.SERVE_DIFFUSION, quant="static"), torch.Generator().manual_seed(21))
    x = _seeded_image(size, 23)
    t_mid = torch.tensor([24])

    def evaluated(model, dev):
        with torch.inference_mode():
            return (model(x.to(dev), x.to(dev), t_mid.to(dev)).cpu(),
                    denoise(model, x.to(dev), make_schedule(config.SERVE_SCHEDULE, dev),
                            config.SERVE_DIFFUSION_STEPS).cpu())

    def side(dev):
        model = copy.deepcopy(base).to(dev).eval()
        sched = make_schedule(config.SERVE_SCHEDULE, dev)
        t = time.time()
        scales = qconv.calibrate_unet_rollout(qconv.with_quant_mode(model, "calibrate"), sched,
                                              calibration_batches(size, dev)[:batches], steps)
        if dev == "cuda":
            torch.cuda.synchronize()
            return model, scales, time.time() - t
        qconv.load_qscales(model, scales)
        out = evaluated(model, dev)
        for mod in model.modules():
            if isinstance(mod, AttentionBlock):
                mod.use_flash = True
        return model, scales, time.time() - t, out, evaluated(model, dev)

    both = on_devices("int8_card_vs_cpu", side)
    (card_model, card_scales, card_s), (_, cpu_scales, _, cpu_out, spread_out) = both["cuda"], both["cpu"]
    scales = {"cuda": card_scales, "cpu": cpu_scales}
    worst = max(abs(scales["cuda"][n].item() - scales["cpu"][n].item()) / scales["cpu"][n].item()
                for n in scales["cpu"])
    qconv.load_qscales(card_model, cpu_scales)
    card_out = evaluated(card_model, "cuda")
    evals, outs = ({"cuda": card_out[i], "cpu": cpu_out[i]} for i in (0, 1))
    spread_eval, spread = spread_out

    def stats(a, b):
        d = (a - b).abs()
        return {"max_abs_diff": d.max().item(), "mean_abs_diff": d.mean().item(),
                "corr": float(np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1])}

    res = {"convs": len(scales["cpu"]), "absmax_max_rel_diff": worst, "absmax_bound": INT8_ABSMAX_REL,
           "card_calibration_s": card_s, "eval_max_abs": evals["cpu"].abs().max().item(),
           "eval": stats(evals["cuda"], evals["cpu"]), "eval_cpu_spread": stats(spread_eval, evals["cpu"]),
           "rollout": stats(outs["cuda"], outs["cpu"]), "rollout_cpu_spread": stats(spread, outs["cpu"]),
           "bounds": {"mean_abs_diff_over_cpu_spread": INT8_SPREAD_RATIO, "rollout_max_abs_diff": INT8_ROLLOUT_MAX,
                      "rollout_corr": INT8_ROLLOUT_CORR}}
    report["int8_card_vs_cpu"] = res
    print(json.dumps({"int8_card_vs_cpu": res}), flush=True)
    assert set(scales["cuda"]) == set(scales["cpu"]) and worst <= INT8_ABSMAX_REL, res
    assert torch.isfinite(outs["cuda"]).all(), res
    for key in ("eval", "rollout"):
        assert res[key]["mean_abs_diff"] <= INT8_SPREAD_RATIO * res[f"{key}_cpu_spread"]["mean_abs_diff"], res
    assert res["rollout"]["max_abs_diff"] <= INT8_ROLLOUT_MAX and res["rollout"]["corr"] >= INT8_ROLLOUT_CORR, res


def serve_1024(report: dict) -> dict:
    """Phase 13: the 1024² operating point at full SERVE_* width. The
    server's ``--img-size 1024`` configuration (auto buckets (1,), flash on
    the card) behind the stdlib server: 3 requests of other sizes, four
    PNGs each, 48 flash forward (N 16384) and 120 ln2d launches a request;
    each path's wall, device time and peak memory. Then two fp32-eval
    engines with TF32 off, ``use_flash_attention`` True and False, on one
    1024² image: the exact path launches no flash kernel and agrees with
    flash to EXACT_VS_FLASH_BOUND on the two rollout paths, both timed.
    Returns the requests' launches."""
    default_tf32()
    _, cfg = server.config_from_args(["--img-size", "1024"])
    t = time.time()
    engine = InferenceEngine(cfg)
    build_s = time.time() - t
    try:
        assert engine.serving_mode()["img_size"] == 1024 and engine.serving_mode()["flash_attention"] is True
        sizes = [(1024, 1024), (1100, 900), (800, 1024)]
        with serving(engine) as addr:
            per_request, walls = [], []
            zero_counts()
            for i, size in enumerate(sizes[:REQUESTS_1024]):
                before = counts()
                walls.append(post_denoise(addr, xray_png(*size, seed=5000 + i), size))
                per_request.append(since(before))
            launched = counts()
        assert all(r == PER_REQUEST for r in per_request), per_request
        x = _png_array(xray_png(1024, 1024, seed=5100))
        for name in MODEL_NAMES:
            y = engine.fns[name](x)
            assert y.shape == (1, 1024, 1024, 1) and np.isfinite(y).all(), name
            assert y.min() >= 0.0 and y.max() <= 1.0, name
        served = path_times(engine, x)
    finally:
        engine.close()
    set_tf32(False)
    fp32 = dict(img_size=1024, warmup=False, diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
    flash, exact = (InferenceEngine(EngineConfig(**fp32, use_flash_attention=f)) for f in (True, False))
    try:
        assert exact.serving_mode()["flash_attention"] is False
        diff, exact_launches = {}, {}
        for name in ("diffusion", "hybrid"):
            before = counts()
            y = exact.fns[name](x)
            exact_launches[name] = since(before)["flash_fwd"]
            diff[name] = float(np.abs(y - flash.fns[name](x)).max())
        compared = {"flash": path_times(flash, x, ("diffusion", "hybrid")),
                    "exact": path_times(exact, x, ("diffusion", "hybrid"))}
    finally:
        flash.close()
        exact.close()
    default_tf32()
    summary = {"engine_build_s": build_s, "request_ms": walls, "launches_per_request": per_request[0],
               "paths": served, "exact_vs_flash_max_abs_diff": diff, "bound": EXACT_VS_FLASH_BOUND,
               "exact_flash_launches": exact_launches, "fp32_evals": compared}
    report["serve_1024"] = summary
    print(json.dumps({"serve_1024": {"request_ms": walls, "launches_per_request": per_request[0],
                                     "exact_vs_flash_max_abs_diff": diff, "bound": EXACT_VS_FLASH_BOUND,
                                     "exact_flash_launches": exact_launches}}), flush=True)
    print(json.dumps({"serve_1024_paths": {n: {k: p[k] for k in ("wall_p50_ms", "device_ms", "idle_share",
                                                                  "peak_gib", "launches")}
                                           for n, p in served.items()}}), flush=True)
    print(json.dumps({"serve_1024_fp32_evals": {e: {n: {k: p[k] for k in ("wall_p50_ms", "device_ms", "peak_gib")}
                                                    for n, p in paths.items()} for e, paths in compared.items()}}),
          flush=True)
    assert all(v == 0 for v in exact_launches.values()), exact_launches
    assert all(d <= EXACT_VS_FLASH_BOUND for d in diff.values()), diff
    return launched


def model2_kernels(report: dict) -> None:
    """Phase 14a: ln2d and naf_ffn against their plain versions at every
    MODEL2_NAFNET stage of a 512² input (C 24 to 384), fp32 and bf16, both
    layouts, with the tolerances of phases 5 and 6 (fp32 ln2d bit for bit);
    fp32 calls timed."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(14)
    rows = []
    for c, s in MODEL2_STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("nchw", "channels_last"):
                x = _in_layout((2.5 + torch.randn(1, c, s, s, generator=gen)).to("cuda", dtype), layout)
                scale, bias = (1 + 0.2 * torch.randn(c, generator=gen)).cuda(), (0.2 * torch.randn(c, generator=gen)).cuda()
                params = _ffn_params(c, gen)
                y, y_ref = ln.ln2d(x, scale, bias), ln.ln2d_plain(x, scale, bias)
                out, out_ref = ffn.naf_ffn_fused(x, *params), ffn.naf_ffn_plain(x, *params)
                torch.cuda.synchronize()
                bf16 = dtype == torch.bfloat16
                row = {"shape": [1, c, s, s], "dtype": _dt(dtype), "layout": layout,
                       "ln2d_max_abs_err": (y.float() - y_ref.float()).abs().max().item(),
                       "ln2d_tol": (LN_BF16_REL if bf16 else LN_FP32_REL) * y_ref.float().abs().max().item(),
                       "ln2d_bitwise_equal": bool(torch.equal(y, y_ref)),
                       "naf_ffn_max_abs_err": (out.float() - out_ref.float()).abs().max().item(),
                       "naf_ffn_tol": (FFN_BF16_REL if bf16 else FFN_FP32_REL) * out_ref.float().abs().max().item()}
                if not bf16:
                    row["ln2d_ms"] = time_ms(lambda: ln.ln2d(x, scale, bias), reps=10)
                    row["naf_ffn_ms"] = time_ms(lambda: ffn.naf_ffn_fused(x, *params), reps=10)
                row["ok"] = (row["ln2d_max_abs_err"] <= row["ln2d_tol"] and (bf16 or row["ln2d_bitwise_equal"])
                             and row["naf_ffn_max_abs_err"] <= row["naf_ffn_tol"]
                             and y.stride() == x.stride() and out.stride() == x.stride())
                print(json.dumps({"model2_kernels": row}), flush=True)
                rows.append(row)
                if not row["ok"]:
                    raise AssertionError(f"a NAFNet kernel disagrees with its plain version at MODEL2: {row}")
    report["model2_kernels"] = rows


def model2_slice(report: dict) -> dict:
    """Phase 14b: MODEL2_NAFNET at 512², fp32 with TF32 off, on perturbed
    seeded weights: the card's module forward against the CPU's (1e-4 of
    max|out|, as phase 9b), then ``nafnet_apply_fused`` against the module
    on the card (one naf_ffn launch per NAFBlock, 1e-4 of max|out| as phase
    7). Returns the fused forward's launches."""
    set_tf32(False)
    model = perturbed_nafnet(27, config.MODEL2_NAFNET).eval()
    assert sum(p.numel() for p in model.parameters()) == 10_803_361
    x = _seeded_image(512, 29)
    with torch.inference_mode():
        cpu = model(x)
        card_model = model.cuda()
        xc = x.cuda()
        module = card_model(xc)
        zero_counts()
        fused = nafnet_apply_fused(card_model, xc)
        torch.cuda.synchronize()
        launched = counts()
        times = {"module_ms": time_ms(lambda: card_model(xc), reps=10),
                 "fused_ms": time_ms(lambda: nafnet_apply_fused(card_model, xc), reps=10)}
    top = cpu.abs().max().item()
    res = {"params": 10_803_361, "card_vs_cpu_max_abs_diff": (module.cpu() - cpu).abs().max().item(),
           "card_vs_cpu_bound": NAFNET_CARD_VS_CPU_REL * top,
           "fused_vs_module_max_abs_diff": (fused - module).abs().max().item(),
           "fused_bound": NAFNET_FUSED_REL * module.abs().max().item(), "launches": launched, **times}
    report["model2"] = res
    print(json.dumps({"model2": res}), flush=True)
    assert launched == {**NO_LAUNCHES, "naf_ffn": MODEL2_BLOCKS}, launched
    assert torch.isfinite(fused).all() and fused.shape == (1, 1, 512, 512)
    assert res["card_vs_cpu_max_abs_diff"] <= res["card_vs_cpu_bound"], res
    assert res["fused_vs_module_max_abs_diff"] <= res["fused_bound"], res
    del card_model
    torch.cuda.empty_cache()
    return launched


class _ScoreCounter:
    """Wraps ``xray_bench.score_fn`` while the phase runs: each scored row's
    images, batches and kernel launches, in call order."""

    def __init__(self):
        self.rows = []
        self._orig = xray_bench.score_fn

    def __enter__(self):
        def counted(fn, eval_set, batch: int = XB_SCORE_BATCH):
            before = counts()
            out = self._orig(fn, eval_set, batch)
            self.rows.append({"images": len(eval_set), "batches": -(-len(eval_set) // batch),
                              "launches": since(before)})
            return out

        xray_bench.score_fn = counted
        return self

    def __exit__(self, *exc):
        xray_bench.score_fn = self._orig

    def take(self) -> list:
        rows, self.rows = self.rows, []
        return rows


def xray_cli(argv: list) -> dict:
    """``xray_bench.main(argv)`` in this process (so that its launches are
    counted), its output kept and shown only when it fails; returns the
    payload, the CLI's own per-phase walls (its ``Timer`` line), the
    Trainer steps it ran and its stderr."""
    out, err = io.StringIO(), io.StringIO()
    steps = [0]
    orig_step = Trainer.train_step

    def counted_step(self, batch):
        steps[0] += 1
        return orig_step(self, batch)

    Trainer.train_step = counted_step
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            payload = xray_bench.main(argv)
    except BaseException:
        print(out.getvalue()[-6000:], flush=True)
        print(err.getvalue()[-6000:], file=sys.stderr, flush=True)
        raise
    finally:
        Trainer.train_step = orig_step
    lines = out.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == payload, lines[-1][:300]
    walls = next(json.loads(line) for line in reversed(err.getvalue().splitlines())
                 if line.startswith('{"event": "xray_bench_s"'))
    return {"payload": payload, "cli_s": {k: v for k, v in walls.items() if k not in ("event", "device")},
            "train_steps": steps[0], "stderr": err.getvalue(), "stdout": lines}


def _check_results(results: dict, rows: list) -> None:
    """Every row finite; a PSNR of None only where every image of the group
    was reconstructed exactly (SSIM 1)."""
    assert list(results) == rows, list(results)
    for name, r in results.items():
        for group, v in r.items():
            assert np.isfinite(v["ssim"]), (name, group, v)
            assert v["psnr"] is None and v["ssim"] == 1.0 or np.isfinite(v["psnr"]), (name, group, v)


def _xb_per_batch(name: str) -> dict:
    """The launches of one scored batch of a benchmark row."""
    flash = 6 * XB_EVALS.get(name, 0)
    ln2d = 60 if name in ("nafnet", "hybrid") else 0
    return {**NO_LAUNCHES, "flash_fwd": flash, "ln2d": ln2d}


def _check_turbo_launches(flash: list) -> None:
    """The turbo gate's flash launches, one batch a row (diffusion, hybrid
    at k = 1, 2, 3): k = 1 is the exact rollout, and each larger stride
    evaluates the UNet fewer times."""
    k1 = _xb_per_batch("diffusion")["flash_fwd"]
    assert flash[0] == flash[1] == k1 and k1 > flash[2] == flash[3] > flash[4] == flash[5], flash


def xray_bench_slice(report: dict, smi: str) -> tuple:
    """Phase 15: the xraybench-v1 CLI on the card at serve widths, 256²:
    (a) --train (tpu profile: the NAFNet and expert polish runs,
    expert_ftl2, the sees_expert hybrid), then --train-wide --train-ddim50
    into the same directory; (b) the score (every row of ``XB_ROWS``,
    finite; the JAX CLI's payload keys; the ``_input`` row equal to the CPU's
    own to 1e-5; each row's flash and ln2d launches a scored batch as its
    exact rollouts and NAFNets make them); (c) card against CPU on the
    trained nafnet and hybrid on the eval set's first image, TF32 off
    (``XB_PSNR_*``, ``XB_SSIM_*``); (d) --turbo-gate at one image per family;
    (e) --seeds 1 --seed-models diffusion twice: the second reuses the
    marked run and trains nothing. Returns the launches of the CLI runs
    (a, b, d, e) and the phase's record."""
    timer = Timer("xraybench_phase_s", stream=sys.stdout, device="cuda")
    default_tf32()
    res = {"card": smi, "cli_s": {}, "launches_per_batch": {}}
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="xraybench_")
    try:
        os.chdir(tmp)  # the recipes write their curves (where matplotlib exists) here
        ck = os.path.join(tmp, "ck")
        common = [*XB_ARGS, "--ckpt-dir", ck, "--n-eval", str(XB_N_EVAL)]
        zero_counts()
        with _ScoreCounter() as scored:
            with timer.section("train"):
                train = xray_cli(["--train", *common])
            assert train["train_steps"] > 0 and list(train["payload"]) == XB_PAYLOAD_KEYS
            for name in ("nafnet", "diffusion", "expert", "expert_ftl2", "hybrid"):
                assert xray_bench.completed_phases(ck, name), name
            with timer.section("train_variants"):
                variants = xray_cli(["--train-wide", "--train-ddim50", *common])
            assert xray_bench.completed_phases(ck, "diffusion_w96") == ("diffusion",)
            assert xray_bench.completed_phases(ck, "diffusion_ddim50") == ("diffusion",)
            scored.take()

            with timer.section("score"):
                score = xray_cli(common)
            rows = scored.take()
            payload = score["payload"]
            assert list(payload) == XB_PAYLOAD_KEYS, list(payload)
            assert payload["protocol"] == xray_bench.PROTOCOL_VERSION and payload["img_size"] == XB_IMG
            assert payload["n_eval"] == 3 * XB_N_EVAL and score["train_steps"] == 0
            _check_results(payload["results"], XB_ROWS)
            for name, row in zip(XB_ROWS, rows):
                per_batch = _xb_per_batch(name)
                want = {k: v * row["batches"] for k, v in per_batch.items()}
                assert row["launches"] == want, (name, row, want)
                res["launches_per_batch"][name] = {k: v for k, v in per_batch.items() if v}
            cpu_input = xray_bench.score_fn(lambda x: x, xray_bench.make_eval_set(XB_N_EVAL, XB_IMG))
            for group, v in cpu_input.items():
                got = payload["results"]["_input"][group]
                assert abs(got["psnr"] - v["psnr"]) <= 1e-5 and abs(got["ssim"] - v["ssim"]) <= 1e-5, group
            scored.take()

            with timer.section("turbo_gate"):
                turbo = xray_cli(["--turbo-gate", "--ckpt-dir", ck, "--img-size", str(XB_IMG), "--n-eval", "1"])
            _check_results(turbo["payload"]["results"],
                           [f"{p}_k{k}" for k in (1, 2, 3) for p in ("diffusion", "hybrid")])
            _check_turbo_launches([r["launches"]["flash_fwd"] for r in scored.take()])

            seed_args = ["--seeds", "1", "--seed-models", "diffusion", *common[:-2], "--n-eval", "1"]
            with timer.section("seed_study"):
                seeds = xray_cli(seed_args)
            with timer.section("seed_study_again"):
                again = xray_cli(seed_args)
            for run in (seeds, again):
                study = run["payload"]["seed_study"]["diffusion"]
                assert [r["seed"] for r in study["rows"]] == [0, 1], study
                assert all(np.isfinite(r["psnr"]) for r in study["rows"]), study
            assert seeds["train_steps"] > 0 and again["train_steps"] == 0, (seeds["train_steps"],
                                                                            again["train_steps"])
            assert "diffusion_s1: reusing the finished run" in again["stderr"], again["stderr"][-2000:]
        launched = counts()

        # (c) card against CPU, through the port on both devices, as the CLI scores
        set_tf32(False)
        eval_set = xray_bench.make_eval_set(1, XB_IMG)[:XB_CARD_VS_CPU_IMAGES]
        kw = dict(img_size=XB_IMG, ckpt_dir=ck, warmup=False, turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1)
        on = {}
        for dev in ("cuda", "cpu"):
            with timer.section(f"card_vs_cpu_{dev}"):
                engine = InferenceEngine(EngineConfig(**kw, device=dev))
                try:
                    on[dev] = xray_bench.score_engine(engine, eval_set, models=XB_CARD_VS_CPU_MODELS)
                finally:
                    engine.close()
        default_tf32()
        diffs = {}
        for name in XB_CARD_VS_CPU_MODELS:
            g, c = on["cuda"][name]["overall"], on["cpu"][name]["overall"]
            diffs[name] = {"psnr_card": g["psnr"], "psnr_cpu": c["psnr"], "ssim_card": g["ssim"],
                           "ssim_cpu": c["ssim"], "psnr_diff": abs(g["psnr"] - c["psnr"]),
                           "ssim_diff": abs(g["ssim"] - c["ssim"])}
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    timer.emit()
    res.update(
        cli_s={"train": train["cli_s"], "train_variants": variants["cli_s"], "score": score["cli_s"],
               "turbo_gate": turbo["cli_s"], "seed_study": seeds["cli_s"], "seed_study_again": again["cli_s"]},
        train_steps={"train": train["train_steps"], "train_variants": variants["train_steps"],
                     "seed_study": seeds["train_steps"], "seed_study_again": again["train_steps"]},
        results=payload["results"], table=score["stdout"][-len(XB_ROWS) - 3:-1],
        turbo_gate={k: v["overall"] for k, v in turbo["payload"]["results"].items()},
        seed_study=seeds["payload"]["seed_study"], card_vs_cpu=diffs, launches=launched,
    )
    report["xraybench"] = res
    for line in res["table"]:
        print(line, flush=True)
    print(json.dumps({"xraybench": {k: res[k] for k in ("cli_s", "train_steps", "launches_per_batch",
                                                         "card_vs_cpu", "launches")}}), flush=True)
    for name, d in diffs.items():
        fp32 = name == "nafnet"
        psnr_tol, ssim_tol = (XB_PSNR_FP32_DB, XB_SSIM_FP32) if fp32 else (XB_PSNR_BF16_DB, XB_SSIM_BF16)
        assert np.isfinite(d["psnr_card"]) and np.isfinite(d["psnr_cpu"]), (name, d)
        assert d["psnr_diff"] <= psnr_tol and d["ssim_diff"] <= ssim_tol, (name, d)
    return launched, res


# Phase 16: rematerialisation and data parallelism, fp32 with TF32 off (the
# comparisons are exact up to reduction order; cuDNN may pick other
# algorithms, such as Winograd, for other batch sizes, whose TF32 errors
# would not be).
REMAT_STEPS = 5  # per mode, from the same weights: the first compared, all timed
REMAT_BATCH = {"diffusion": 1, "expert": 4}  # the CLIs' batches
# The remat step's first forward is the plain step's, and its backward
# consumes recomputed activations equal to the saved ones: the loss to 1e-6,
# all gradients together to 1e-5 in L2 (reduction order inside cuDNN's
# weight gradients only), the weights after the step to 2 lr with at most
# 1% of the entries beyond 1e-6 (Adam's first step, ~ lr * g / |g|, turns a
# gradient's rounding into a move anywhere in +-lr where the gradient is
# rounding noise), and the BatchNorm buffers bit for bit (moved in the first
# forward only).
REMAT_LOSS_REL = 1e-6
REMAT_GRAD_REL_L2 = 1e-5
REMAT_LOOSE_SHARE = 0.01
DP_MODELS = ("diffusion", "nafnet", "expert")
DP_BATCH = {"diffusion": 2, "nafnet": 2, "expert": 4}
DP_STEPS = 4  # of the global batch
DP_PAIRS = {m: DP_STEPS * b for m, b in DP_BATCH.items()}
DP_TIMEOUT_S = 420  # the torchrun launch: 2 ranks' start-up, 4 runs, validations
DP_PER_STEP = {"diffusion": {**NO_LAUNCHES, "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6},
               "nafnet": {**NO_LAUNCHES, "ln2d": 60}, "expert": NO_LAUNCHES}
# dp 2 against one process on the same global batches and draws: the
# gradients differ by the order of the batch reduction (two half-batch
# means averaged, ~1e-7 of each), which Adam's sign-like first steps turn
# into moves of up to +-lr on entries whose gradient is rounding noise, and
# which later steps carry; the expert's 13 train-mode BatchNorms amplify a
# moved weight into the next gradients (PERF.md section 2). Bounds from a
# first chip measurement (NVIDIA H100 80GB HBM3, 700 W; 4 steps; PERF.md
# section 6), with the margin beside each:
DP_LOSS_REL = 1e-5  # each step's global loss; measured <= 4.6e-7
# ||w_dp - w_one|| / ||w_one - w_0|| over all parameters: measured 5.5e-6
# (diffusion), 7.2e-6 (NAFNet), 0.024 (expert)
DP_UPDATE_REL_L2 = {"diffusion": 1e-4, "nafnet": 1e-4, "expert": 0.1}
DP_STATS_REL = 2e-3  # each BatchNorm buffer, max |dp - one| / max |one|; measured 2.0e-4


def _train_batch(seed: int, b: int) -> tuple:
    return tuple(torch.from_numpy(a).cuda() for a in _step_batch(seed, size=TRAIN_SIZE, b=b))


def remat_pair(name: str, build, loss_fn, batch: tuple, draw, lr: float) -> dict:
    """REMAT_STEPS plain steps and REMAT_STEPS remat steps of ``build()``'s
    model, each run from the same weights on ``batch`` and ``draw``: the
    first step's loss, gradients, weights and buffers compared, every step's
    wall, the launches and the peak memory of each run."""
    has_bn = name == "expert"
    out = {}
    for remat in (False, True):
        model = build()
        cfg = dataclasses.replace(recipes.default_train_config(name), batch_size=batch[0].shape[0], remat=remat)
        trainer = Trainer(loss_fn, None, cfg, model, lambda b, g: draw, has_batch_stats=has_bn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        walls, first = [], None
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            loss = trainer.train_step(batch)  # a host float: the step has finished
            walls.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = {"loss": loss, "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
                         "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}
        out[remat] = {**first, "launches": counts(), "step_ms": walls,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "peak_above_start_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        del trainer, model
        torch.cuda.empty_cache()
    plain, rem = out[False], out[True]
    g_num = sum((rem["grads"][n] - g).double().square().sum().item() for n, g in plain["grads"].items())
    g_den = sum(g.double().square().sum().item() for g in plain["grads"].values())
    diffs = [(rem["state"][k] - v).abs() for k, v in plain["state"].items() if v.is_floating_point()
             and not k.endswith(("running_mean", "running_var"))]
    buffers = [k for k in plain["state"] if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    res = {"loss": [plain["loss"], rem["loss"]], "loss_rel_diff": abs(rem["loss"] - plain["loss"]) / abs(plain["loss"]),
           "grad_rel_l2": (g_num / g_den) ** 0.5, "weight_max_abs_diff": max(d.max().item() for d in diffs),
           "weight_loose_share": sum(int((d > 1e-6).sum()) for d in diffs) / sum(d.numel() for d in diffs),
           "buffers_equal": all(torch.equal(rem["state"][k], plain["state"][k]) for k in buffers),
           "buffers": len(buffers), "lr": lr,
           **{mode: {"launches": o["launches"], "step_ms": o["step_ms"],
                     "step_ms_median_after_first": statistics.median(o["step_ms"][1:]), "peak_gib": o["peak_gib"],
                     "peak_above_start_gib": o["peak_above_start_gib"]}
              for mode, o in (("plain", plain), ("remat", rem))}}
    if has_bn:
        res["num_batches_tracked"] = int(rem["state"]["inc.1.num_batches_tracked"])
    return res


def remat_slice(report: dict, smi: str) -> dict:
    """Phase 16a: ``TrainConfig(remat=True)`` against the plain step at 512²,
    SERVE_DIFFUSION at batch 1 (flash forward, dq and dk/dv; the forward's 6
    flash launches run again in the backward: 12 a step) and SERVE_EXPERT at
    batch 4 (train-mode BatchNorm, buffers moved once). Returns the remat
    runs' launches."""
    set_tf32(False)
    sched = make_schedule(config.SERVE_SCHEDULE, "cuda")
    batch = _train_batch(61, REMAT_BATCH["diffusion"])
    draw = diffusion_draw(sched)(batch, torch.Generator(device="cuda").manual_seed(62))
    res = {"card": smi, "diffusion": remat_pair(
        "diffusion", lambda: init_weights(UNetDiffusion(config.SERVE_DIFFUSION), torch.Generator().manual_seed(63)),
        diffusion_loss_fn(sched), batch, draw, recipes.default_train_config("diffusion").lr)}
    res["expert"] = remat_pair(
        "expert", lambda: init_weights(ExpertDenoiser(config.SERVE_EXPERT), torch.Generator().manual_seed(64)),
        expert_loss_fn(), _train_batch(65, REMAT_BATCH["expert"]), None, recipes.default_train_config("expert").lr)
    report["remat"] = res
    print(json.dumps({"remat": res}), flush=True)
    flash = {**NO_LAUNCHES, "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}
    d = res["diffusion"]
    assert d["plain"]["launches"] == {k: REMAT_STEPS * v for k, v in flash.items()}, d
    assert d["remat"]["launches"] == {**{k: REMAT_STEPS * v for k, v in flash.items()},
                                      "flash_fwd": REMAT_STEPS * 12}, d
    assert res["expert"]["plain"]["launches"] == res["expert"]["remat"]["launches"] == NO_LAUNCHES, res
    assert res["expert"]["num_batches_tracked"] == 1 and res["expert"]["buffers"] == 39, res
    for name in ("diffusion", "expert"):
        r = res[name]
        assert r["loss_rel_diff"] <= REMAT_LOSS_REL and r["grad_rel_l2"] <= REMAT_GRAD_REL_L2, (name, r)
        assert r["weight_max_abs_diff"] <= 2 * r["lr"] and r["weight_loose_share"] <= REMAT_LOOSE_SHARE, (name, r)
        assert r["buffers_equal"], (name, r)
    return {k: res["diffusion"]["remat"]["launches"][k] + res["expert"]["remat"]["launches"][k] for k in NO_LAUNCHES}


def wait_for_files(paths: list, what: str) -> None:
    """Wait until every one of ``paths`` exists, bounded by DP_TIMEOUT_S."""
    deadline = time.time() + DP_TIMEOUT_S
    while not all(os.path.exists(p) for p in paths):
        if time.time() > deadline:
            raise TimeoutError(f"{what}: {paths} not written in {DP_TIMEOUT_S} s")
        time.sleep(0.5)


def dp_rank_main(job_path: str) -> int:
    """One rank of phase 18's torchrun launches (``--dp-rank JOB``): each run
    of the job through ``recipes.main`` in its directory, with TF32 off,
    under ``trainer_probe``, a run with ``after`` once those files exist
    (another launch's records, bounded by DP_TIMEOUT_S); writes
    ``JOB.rank<RANK>.json``."""
    import torch.distributed as dist

    with open(job_path) as f:
        job = json.load(f)
    set_tf32(False)
    runs = []
    for run in job["runs"]:
        wait_for_files(run.get("after", []), run["name"])
        record, state = recipe_run(run["cwd"], run["argv"])
        runs.append({"name": run["name"], **record, "device": str(next(state.model.parameters()).device)})
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(), "runs": runs}
    with open(f"{job_path}.rank{out['rank']}.json.tmp", "w") as f:
        json.dump(out, f)
    os.replace(f"{job_path}.rank{out['rank']}.json.tmp", f"{job_path}.rank{out['rank']}.json")
    dist.destroy_process_group()
    return 0


def torchrun_start(job: dict, tmp: str, nproc: int = 2, name: str = "dp_job") -> dict:
    """Start ``job`` in ``nproc`` ranks on the one card: ``python -m
    torch.distributed.run --standalone --nproc_per_node NPROC`` of this
    script's ``--dp-rank`` mode, its output into a file (launches may
    run at once). Returns the launch for ``torchrun_wait``; each rank's
    record will be ``rank_files(launch)``."""
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           os.path.abspath(__file__), "--dp-rank", path]
    log = open(f"{path}.log", "w")
    # ranks sharing one card: segments that grow in place leave less of it cached and unusable by the others
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.Popen(cmd, cwd=tmp, stdout=log, stderr=subprocess.STDOUT, text=True, start_new_session=True,
                            env=env)
    log.close()
    return {"proc": proc, "path": path, "nproc": nproc, "t0": time.perf_counter()}


def card_memory_used() -> str:
    """The card's memory in use, all processes, as ``nvidia-smi`` reads it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def rank_files(launch: dict) -> list:
    return [f"{launch['path']}.rank{r}.json" for r in range(launch["nproc"])]


def torchrun_wait(launch: dict) -> tuple:
    """Wait for a launch, bounded by DP_TIMEOUT_S from its start (on expiry
    the whole process group is killed and the phase fails). Returns every
    rank's record and the launch's wall."""
    proc, nproc = launch["proc"], launch["nproc"]
    try:
        proc.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - launch["t0"])))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    wall_s = time.perf_counter() - launch["t0"]
    with open(f"{launch['path']}.log") as f:
        out = f.read()
    print("\n".join(line for line in out.splitlines() if "init_distributed" in line or "epoch" in line), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{nproc} ranks exited {proc.returncode} after {wall_s:.1f} s:\n{out[-6000:]}")
    ranks = []
    for path in rank_files(launch):
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks, wall_s


def _weights_compare(dp: dict, one: dict, fresh: dict) -> dict:
    """dp-2's ``.pth`` against one process's: the weights' distance over
    their update, the largest entry apart, the BatchNorm buffers."""
    params = [k for k, v in fresh.items() if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))]
    num = sum((dp[k].double() - one[k].double()).square().sum().item() for k in params)
    den = sum((one[k].double() - fresh[k].double()).square().sum().item() for k in params)
    stats = [k for k in fresh if k.endswith(("running_mean", "running_var"))]
    return {"update_rel_l2": (num / den) ** 0.5, "weight_max_abs_diff": max(
                (dp[k] - one[k]).abs().max().item() for k in params),
            "stats_max_rel": max(((dp[k] - one[k]).abs().max() / one[k].abs().max()).item() for k in stats)
            if stats else None,
            "buffers_counter": [int(dp[k]) for k in fresh if k.endswith("num_batches_tracked")][:1]}


def _runs(ranks: list, name: str) -> list:
    """Each rank's record of the run ``name`` of a torchrun job."""
    return [next(run for run in r["runs"] if run["name"] == name) for r in ranks]


def row_split_params(model: torch.nn.Module) -> int:
    """The parameters of the convolutions that the sp split takes: every
    ``Conv2d`` and ``ConvTranspose2d`` but the NAFBlocks' SCA
    (``parallel/sp.py``)."""
    return sum(len(list(m.parameters(recurse=False))) for n, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and "sca" not in n.split("."))


def parallel_training_slice(report: dict, smi: str, meanwhile) -> tuple:
    """Phases 16b-c, 18a-b, 19b and 21: the recipes CLI under torchrun on
    the one card, 512², TF32 off, seeded weights, in launches that the
    phases share (each process takes seconds to reach the card). First 8
    ranks (21's ``--mesh 2,2,2``, SERVE_NAFNET at batch 2 for 2 steps),
    beside the one-process references that fit beside them on the card;
    then, at once, 4 ranks (18b's ``--mesh 2,1,2`` and 19b's ``--mesh
    2,2,1``, SERVE_NAFNET at batch 2 for 2 steps; 21's ``--mesh 1,2,2``
    SERVE_DIFFUSION at batch 1 for 3 steps; the 8 ranks' ``.pth`` resumed at
    ``--mesh 2,1,2``) and 2 ranks (16b's ``--mesh 2,1,1`` diffusion at batch
    2, nafnet 2 and expert 4 for ``DP_STEPS`` steps; 18a's ``--mesh 1,1,2``
    and 19b's ``--mesh 1,2,1`` SERVE_DIFFUSION at batch 1 for 3 steps; 16c's
    one-process diffusion ``.pth`` resumed at dp 2; once the 4-rank launch
    has ended, its NAFNet ``.pth`` files resumed at tp 2 and at sp 2).
    (Three launches at once, the 2-rank jobs split, were no faster: the
    ranks then contend for the host's cores; the 8 ranks beside the 2-rank
    launch ran out of the card's memory.) Each run against the same CLI in
    this process (dp's on its own pairs; tp's, sp's and sp x tp's on the
    same pairs, one reference for all), and each parallel NAFNet ``.pth``
    resumed here too. A resumed run trains one step of its second epoch;
    every resume is checked against its file as it loads
    (``restored_matches``). ``meanwhile()`` runs here once the 4-rank
    launch has ended, beside the 2-rank one's last runs. Ranks that share
    one card are a correctness run, not a speed result. Returns each
    parallel run's launches, all ranks summed, and what ``meanwhile()``
    returned."""
    set_tf32(False)
    with tempfile.TemporaryDirectory() as tmp:
        dp_data = {m: write_pairs(os.path.join(tmp, "data_dp", m), DP_PAIRS[m], TRAIN_SIZE) for m in DP_MODELS}
        tp_data = {m: write_pairs(os.path.join(tmp, "data_tp", m), TP_PAIRS[m], TRAIN_SIZE) for m in TP_MODELS}

        def argv(m, data, pairs, batch, resume):
            # a resumed run trains one step of its second epoch: the resume is checked as it loads
            return ["--model", m, "--clear-dir", data[m][0], "--noisy-dirs", data[m][1], "--img-size",
                    str(TRAIN_SIZE), "--epochs", "2" if resume else "1", "--max-samples",
                    str(batch[m] if resume else pairs[m]), "--batch-size", str(batch[m]),
                    *(["--resume", resume] if resume else [])]

        def dp_argv(m, resume=None):
            return argv(m, dp_data, DP_PAIRS, DP_BATCH, resume)

        def tp_argv(m, resume=None):
            return argv(m, tp_data, TP_PAIRS, TP_BATCH, resume)

        def pth(kind, m):
            return os.path.join(tmp, kind, m, "checkpoints", f"{m}.pth")

        def run(name, kind, m, args, after=()):
            return {"name": name, "cwd": os.path.join(tmp, kind, m), "argv": args, "after": list(after)}

        meshes = {"dp": {m: "2,1,1" for m in DP_MODELS}, "tp": TP_MESH, "sp": SP_MESH, "sptp": SPTP_MESH}
        eight = {"runs": [run("sptp_nafnet", "sptp", "nafnet", tp_argv("nafnet") + ["--mesh", SPTP_MESH["nafnet"]])]}
        four = {"runs": [*(run(f"{kind}_{m}", kind, m, tp_argv(m) + ["--mesh", meshes[kind][m]])
                           for kind, m in (("tp", "nafnet"), ("sp", "nafnet"), ("sptp", "diffusion"))),
                         run("resume_sptp_nafnet", "sptp_resume", "nafnet", tp_argv("nafnet", pth("sptp", "nafnet"))
                             + ["--mesh", RESUME_MESH["sptp"]])]}
        gc.collect()  # the 8 ranks take most of the card: beside the 2-rank launch they ran out of it
        torch.cuda.empty_cache()
        print(json.dumps({"before_8_ranks": {"reserved_gib": torch.cuda.memory_reserved() / 2**30,
                                             "card_used": card_memory_used()}}), flush=True)
        launches = [torchrun_start(eight, tmp, nproc=8, name="eight_job")]
        try:
            # the one-process references, beside the 8 ranks those that fit there on the card beside
            # the pins' compile workers (the dp diffusion and expert ones, 26 and 18 GiB at their
            # peaks, run beside the 4-rank launch)
            single = {"tp": {}, "dp": {}}
            for kind, m in (("tp", "nafnet"), ("tp", "diffusion"), ("dp", "nafnet")):
                torch.cuda.empty_cache()
                argv_m = dp_argv(m) if kind == "dp" else tp_argv(m)
                single[kind][m] = recipe_run(os.path.join(tmp, f"one_{kind}", m), argv_m)[0]
            eight_ranks, eight_s = torchrun_wait(launches[0])
            four_job = torchrun_start(four, tmp, nproc=4, name="four_job")
            launches.append(four_job)
            for m in ("diffusion", "expert"):
                torch.cuda.empty_cache()
                single["dp"][m] = recipe_run(os.path.join(tmp, "one_dp", m), dp_argv(m))[0]
            torch.cuda.empty_cache()  # the 2-rank launch shares the card too
            two = {"runs": [  # beside the 4-rank launch, the card shared; what needs that launch's .pth waits
                *(run(f"dp_{m}", "dp", m, dp_argv(m) + ["--mesh", "2,1,1"]) for m in DP_MODELS),
                run("tp_diffusion", "tp", "diffusion", tp_argv("diffusion") + ["--mesh", TP_MESH["diffusion"]]),
                run("resume_one_at_dp2", "dp_resume", "diffusion",
                    dp_argv("diffusion", pth("one_dp", "diffusion")) + ["--mesh", "2,1,1"]),
                run("sp_diffusion", "sp", "diffusion", tp_argv("diffusion") + ["--mesh", SP_MESH["diffusion"]]),
                *(run(f"resume_{kind}_nafnet", f"{kind}_resume", "nafnet", tp_argv("nafnet", pth(kind, "nafnet"))
                      + ["--mesh", RESUME_MESH[kind]], after=rank_files(four_job)) for kind in ("tp", "sp")),
            ]}
            two_job = torchrun_start(two, tmp, nproc=2, name="two_job")
            launches.append(two_job)
            four_ranks, four_s = torchrun_wait(four_job)
            in_one = {kind: recipe_run(os.path.join(tmp, f"one_resume_{kind}", "nafnet"),
                                       tp_argv("nafnet", pth(kind, "nafnet")))[0] for kind in ("tp", "sp", "sptp")}
            beside = meanwhile()
            wait_for_files([pth("dp", "diffusion")], "the 2-rank launch's dp diffusion .pth")
            in_one["dp"] = recipe_run(os.path.join(tmp, "one_resume_dp", "diffusion"),
                                      dp_argv("diffusion", pth("dp", "diffusion")))[0]
            two_ranks, two_s = torchrun_wait(two_job)
        finally:
            for launch in launches:
                if launch["proc"].poll() is None:
                    os.killpg(launch["proc"].pid, signal.SIGKILL)
                    launch["proc"].wait()

        def fresh(m):
            build = {"diffusion": lambda: UNetDiffusion(config.SERVE_DIFFUSION),
                     "nafnet": lambda: EnhancedNAFNet(config.SERVE_NAFNET),
                     "expert": lambda: ExpertDenoiser(config.SERVE_EXPERT)}[m]
            return init_weights(build(), torch.Generator().manual_seed(42))

        def compared(kind, m, ranks, launch_s):
            """A parallel run's record against the one-process run of the same pairs."""
            runs, one = _runs(ranks, f"{kind}_{m}"), single["dp" if kind == "dp" else "tp"][m]
            model = fresh(m)
            w0 = model.state_dict()
            got = torch.load(pth(kind, m), map_location="cpu", weights_only=True)["model_state_dict"]
            want = torch.load(pth("one_dp" if kind == "dp" else "one_tp", m), map_location="cpu",
                              weights_only=True)["model_state_dict"]
            return {
                "mesh": meshes[kind][m], "batch": (DP_BATCH if kind == "dp" else TP_BATCH)[m],
                "launch_s": launch_s, "backend": [r["backend"] for r in ranks], "world": [r["world"] for r in ranks],
                "steps": [r["steps"] for r in runs], "devices": [r["device"] for r in runs],
                "n_sharded": [r["n_sharded"] for r in runs], "row_split": [r["row_split"] for r in runs],
                "row_split_want": row_split_params(model), "losses": [r["losses"] for r in runs],
                "losses_one": one["losses"],
                "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(runs[0]["losses"], one["losses"])),
                "step_ms": [r["step_ms"] for r in runs], "step_ms_one": one["step_ms"],
                "step_ms_median_after_first": {"ranks": [r["step_ms_median_after_first"] for r in runs],
                                               "one": one["step_ms_median_after_first"]},
                "launches_per_step_per_rank": [r["launches_per_step"] for r in runs],
                "launches_per_rank": [r["launches"] for r in runs],
                "peak_gib_per_rank": [r["peak_memory_gib"] for r in runs], "peak_gib_one": one["peak_memory_gib"],
                "pth_keys_unsharded": list(got) == list(w0), **_weights_compare(got, want, w0),
            }

        res = {kind: {"card": smi, "note": "ranks share one card over gloo: a correctness run, not a speed result"}
               for kind in meshes}
        ran = {4: (four_ranks, four_s), 2: (two_ranks, two_s), 8: (eight_ranks, eight_s)}
        for kind, models in meshes.items():
            for m, mesh in models.items():
                res[kind][m] = compared(kind, m, *ran[math.prod(int(x) for x in mesh.split(","))])
        res["dp"]["resume"] = {
            "one_at_dp2": [r["resumed"] for r in _runs(two_ranks, "resume_one_at_dp2")],
            "one_at_dp2_epochs": [len(r["history"]["losses"]) for r in _runs(two_ranks, "resume_one_at_dp2")],
            "dp2_in_one": in_one["dp"]["resumed"], "dp2_in_one_epochs": len(in_one["dp"]["history"]["losses"])}
        for kind, ranks in (("tp", two_ranks), ("sp", two_ranks), ("sptp", four_ranks)):
            at = _runs(ranks, f"resume_{kind}_nafnet")
            res[kind]["resume"] = {"mesh": meshes[kind]["nafnet"], "in_one": in_one[kind]["resumed"],
                                   "in_one_epochs": len(in_one[kind]["history"]["losses"]), "at": RESUME_MESH[kind],
                                   "at_mesh": [r["resumed"] for r in at],
                                   "at_mesh_epochs": [len(r["history"]["losses"]) for r in at]}
    report.update(dp=res["dp"], tp_train=res["tp"], sp_train=res["sp"], sptp_train=res["sptp"])
    for kind in meshes:
        print(json.dumps({f"{kind}_train": res[kind]}), flush=True)

    for kind, models in meshes.items():
        for m in models:
            r = res[kind][m]
            nproc = math.prod(int(x) for x in r["mesh"].split(","))
            assert r["backend"] == ["gloo"] * nproc and r["world"] == [nproc] * nproc, (kind, m, r)
            steps = DP_STEPS if kind == "dp" else TP_STEPS[m]
            assert r["steps"] == [steps] * nproc and r["devices"] == ["cuda:0"] * nproc, (kind, m, r)
            split = TP2_TRAIN_SHARDED[m] if kind in ("tp", "sptp") else 0
            assert r["n_sharded"] == [split] * nproc, (kind, m, r["n_sharded"])
            rows = r["row_split_want"] if kind in ("sp", "sptp") else 0
            assert r["row_split"] == [rows] * nproc, (kind, m, r["row_split"])
            assert all(losses == r["losses"][0] for losses in r["losses"]), (kind, m, r["losses"])
            assert all(n == DP_PER_STEP[m] for rank in r["launches_per_step_per_rank"] for n in rank), (kind, m)
            assert r["loss_max_rel_diff"] <= DP_LOSS_REL and r["update_rel_l2"] <= DP_UPDATE_REL_L2[m], (kind, m, r)
            assert r["weight_max_abs_diff"] <= 2 * steps * recipes.default_train_config(m).lr, (kind, m, r)
            assert r["pth_keys_unsharded"], (kind, m)
    expert = res["dp"]["expert"]
    assert expert["stats_max_rel"] <= DP_STATS_REL and expert["buffers_counter"] == [DP_STEPS], res
    rs = res["dp"]["resume"]
    assert rs["one_at_dp2"] == [[True], [True]] and rs["dp2_in_one"] == [True], rs
    assert rs["one_at_dp2_epochs"] == [2, 2] and rs["dp2_in_one_epochs"] == 2, rs
    for kind in ("tp", "sp", "sptp"):
        rs = res[kind]["resume"]
        nproc = math.prod(int(x) for x in rs["at"].split(","))
        assert rs["in_one"] == [True] and rs["in_one_epochs"] == 2, (kind, rs)
        assert rs["at_mesh"] == [[True]] * nproc and rs["at_mesh_epochs"] == [2] * nproc, (kind, rs)
    return {f"{'dp' if kind == 'dp' else 'train_' + kind}_{m}": {
                k: sum(rank[k] for rank in res[kind][m]["launches_per_rank"]) for k in NO_LAUNCHES}
            for kind, models in meshes.items() for m in models}, beside


def parallel_serving_slice(report: dict, smi: str, unsharded: dict) -> dict:
    """Phase 17: the engine's ``tensor_parallel`` and ``data_parallel`` on
    the one card (``devices=["cuda:0"] * 2``), SERVE_* widths, 512², TF32
    off, seeded demo weights (the same in every engine): (a) tp 2 against
    the unsharded engine, fp32 evals, fused requests and the turbo tier on:
    ``n_tp_sharded``, launches a request (fused, and the four per-path
    functions), the four paths', the fused and the turbo functions' max abs
    difference, every path's wall and device time beside the unsharded
    engine's; (b) dp 2 with batching, buckets (1, 2) -> (2,): 3 requests
    through the server, one 2-row batch each (96 flash, 240 ln2d), then a
    batch of two images against each served alone by the unsharded engine;
    (c) the default engine (bf16 UNet evals) at tp 2 against unsharded.
    (Int8 under tp is phase 18c.) The unsharded fp32 and default engines
    stay open in ``unsharded`` ("fp32", "default") for phase 19. Returns the
    launches of (a)'s and (b)'s requests."""
    set_tf32(False)
    fp32 = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False, warmup=False)
    pngs = [xray_png(512, 512, seed=5000 + i) for i in range(PARALLEL_REQUESTS)]
    x2 = np.concatenate([_png_array(png) for png in pngs[:2]])
    x = x2[:1]
    two = ["cuda:0"] * 2
    res = {"card": smi, "note": "tp and dp slices share one card: a correctness run, not a speed result"}
    launched = {}
    t = time.time()
    plain = unsharded["fp32"] = InferenceEngine(EngineConfig(**fp32, fused_request=True, adaptive_turbo=True))
    tp = InferenceEngine(EngineConfig(**fp32, fused_request=True, adaptive_turbo=True, tensor_parallel=True),
                         devices=two)
    res["engine_build_s"] = time.time() - t
    try:
        res["tp"] = {"mesh_shape": tp.mesh_shape, "n_tp_sharded": tp.n_tp_sharded}
        zero_counts()
        per_request = []
        for i, png in enumerate(pngs):
            before = counts()
            out = tp.process_all(_png_array(png), (512, 512))
            per_request.append(since(before))
            assert all(out[n] is not None for n in MODEL_NAMES), f"tp request {i}: a path answered null"
        launched["serve_tp"] = counts()
        before = counts()
        got = {n: tp.fns[n](x) for n in MODEL_NAMES}
        per_path_request = since(before)
        want = {n: plain.fns[n](x) for n in MODEL_NAMES}
        fused_got, fused_want = tp.fused(x), plain.fused(x)
        res["tp"].update({
            "launches_per_request": per_request, "launches_per_path_request": per_path_request,
            "max_abs_diff": {n: float(np.abs(got[n] - want[n]).max()) for n in MODEL_NAMES},
            "fused_max_abs_diff": {n: float(np.abs(fused_got[n] - fused_want[n]).max()) for n in MODEL_NAMES},
            "turbo_max_abs_diff": {n: float(np.abs(tp.turbo_fns[n](x) - plain.turbo_fns[n](x)).max())
                                   for n in tp.turbo_fns},
            "bound": TP_FP32_BOUND,
        })
        times = {"tp2": path_times(tp, x), "unsharded": path_times(plain, x)}
        res["tp"]["paths"] = {e: {n: {k: p[k] for k in ("wall_p50_ms", "device_ms", "idle_share", "peak_gib")}
                                  for n, p in paths.items()} for e, paths in times.items()}
    finally:
        tp.close()
    print(json.dumps({"parallel_tp": res["tp"]}), flush=True)

    dp = InferenceEngine(EngineConfig(**fp32, batching=True, batch_buckets=(1, 2), data_parallel=True),
                         devices=two)
    try:
        res["dp"] = {"mesh_shape": dp.mesh_shape, "buckets": dp.batcher.buckets}
        with serving(dp) as addr:
            zero_counts()
            per_batch, walls = [], []
            for png in pngs:
                before = counts()
                walls.append(post_denoise(addr, png, (512, 512)))
                per_batch.append(since(before))
            launched["serve_dp"] = counts()
        stats = dp.batcher.stats
        got = {n: dp.fns[n](x2) for n in MODEL_NAMES}
        res["dp"].update({
            "request_ms": walls, "batches": stats["batches"], "launches_per_batch": per_batch,
            "max_abs_diff_vs_unsharded": {
                n: float(max(np.abs(got[n][i:i + 1] - plain.fns[n](x2[i:i + 1])).max() for i in range(2)))
                for n in MODEL_NAMES},
            "bound": DP_VS_ONE_BOUND,
        })
    finally:
        dp.close()
    print(json.dumps({"parallel_dp": res["dp"]}), flush=True)

    default = unsharded["default"] = InferenceEngine(EngineConfig(warmup=False))
    tp_bf16 = InferenceEngine(EngineConfig(warmup=False, tensor_parallel=True), devices=two)
    try:
        # the conv and linear slices hold the cast weights (transposed convs stay fp32)
        shard_dtypes = {s.weight.dtype for m in tp_bf16.replicas[0]["unet_eval"].modules()
                        if isinstance(m, ColumnParallel) for s in m.shards
                        if isinstance(s, (torch.nn.Conv2d, torch.nn.Linear))}
        res["tp_bf16"] = {
            "n_tp_sharded": tp_bf16.n_tp_sharded, "unet_eval_shard_dtypes": sorted(map(str, shard_dtypes)),
            "max_abs_diff": {n: float(np.abs(tp_bf16.fns[n](x) - default.fns[n](x)).max()) for n in MODEL_NAMES},
            "bound": {"diffusion": TP_BF16_BOUND, "hybrid": TP_BF16_BOUND, "nafnet": TP_FP32_BOUND,
                      "expert": TP_FP32_BOUND},
        }
    finally:
        tp_bf16.close()
    print(json.dumps({"parallel_tp_bf16": res["tp_bf16"]}), flush=True)
    report["parallel_serving"] = res

    tp_res, dp_res, bf = res["tp"], res["dp"], res["tp_bf16"]
    assert tp_res["mesh_shape"] == {"dp": 1, "sp": 1, "tp": 2}, tp_res["mesh_shape"]
    assert tp_res["n_tp_sharded"] == bf["n_tp_sharded"] == TP2_SERVE_SHARDED, (tp_res["n_tp_sharded"], bf)
    assert all(r == PER_REQUEST for r in tp_res["launches_per_request"]), tp_res["launches_per_request"]
    assert tp_res["launches_per_path_request"] == PER_REQUEST, tp_res["launches_per_path_request"]
    for key in ("max_abs_diff", "fused_max_abs_diff", "turbo_max_abs_diff"):
        assert max(tp_res[key].values()) <= TP_FP32_BOUND, (key, tp_res[key])
    assert dp_res["mesh_shape"] == {"dp": 2, "sp": 1, "tp": 1} and dp_res["buckets"] == [2], dp_res
    assert dp_res["batches"] == PARALLEL_REQUESTS, dp_res
    assert all(b == _launches(2 * PER_REQUEST["flash_fwd"], 2 * PER_REQUEST["ln2d"])
               for b in dp_res["launches_per_batch"]), dp_res["launches_per_batch"]
    assert max(dp_res["max_abs_diff_vs_unsharded"].values()) <= DP_VS_ONE_BOUND, dp_res
    assert bf["unet_eval_shard_dtypes"] == ["torch.bfloat16"], bf
    assert all(bf["max_abs_diff"][n] <= bf["bound"][n] for n in MODEL_NAMES), bf
    return launched


def int8_tp_slice(report: dict, smi: str, unsharded: dict, scales: dict) -> dict:
    """Phase 18c: the server's ``--int8 --tp`` configuration (static int8)
    at tp 2 on the one card (``devices=["cuda:0"] * 2``) against the
    unsharded static-int8 engine, 512², fp32 evals, TF32 off, fused requests
    and the turbo tier on, both serving the scales that the unsharded
    engine calibrated (calibrated whole, then split): ``n_tp_sharded``, 3
    requests through ``process_all`` (48 flash forward and 120 ln2d
    launches each), each path's, the fused and the turbo functions' max abs
    difference (``INT8_TP_BOUND``). The unsharded engine serves ``scales``,
    phase 12's, and stays open in ``unsharded["int8"]`` for phase 19.
    Returns the requests' launches."""
    set_tf32(False)
    fp32 = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False, warmup=False, fused_request=True,
                adaptive_turbo=True)
    _, cfg = server.config_from_args(["--int8", "--tp"])
    assert cfg.quantize_int8 == "static" and cfg.tensor_parallel, cfg
    t = time.time()
    with carried_scales(scales):
        plain = unsharded["int8"] = InferenceEngine(dataclasses.replace(cfg, tensor_parallel=False, **fp32))
    res = {"card": smi, "note": "the tp slices share one card: a correctness run, not a speed result",
           "unsharded_build_s": time.time() - t, "scales": "phase 12's calibration"}
    with carried_scales(plain.int8_scales):
        tp = InferenceEngine(dataclasses.replace(cfg, **fp32), devices=["cuda:0"] * 2)
    try:
        slices = [s for key in ("unet_eval", "hyb_unet_eval") for m in tp.replicas[0][key].modules()
                  if isinstance(m, ColumnParallel) for s in m.shards if isinstance(s, qconv.QuantConv2d)]
        res.update({"mesh_shape": tp.mesh_shape, "n_tp_sharded": tp.n_tp_sharded, "int8_slices": len(slices),
                    "slices_static_on_their_device": all(
                        s.mode == "static" and s.act_absmax.device == s.weight.device for s in slices)})
        pngs = [xray_png(512, 512, seed=6000 + i) for i in range(PARALLEL_REQUESTS)]
        zero_counts()
        per_request = []
        for i, png in enumerate(pngs):
            before = counts()
            out = tp.process_all(_png_array(png), (512, 512))
            per_request.append(since(before))
            assert all(out[n] is not None for n in MODEL_NAMES), f"int8 tp request {i}: a path answered null"
        launched = counts()
        x = _png_array(pngs[0])
        fused_got, fused_want = tp.fused(x), plain.fused(x)
        res.update({
            "launches_per_request": per_request,
            "max_abs_diff": {n: float(np.abs(tp.fns[n](x) - plain.fns[n](x)).max()) for n in MODEL_NAMES},
            "fused_max_abs_diff": {n: float(np.abs(fused_got[n] - fused_want[n]).max()) for n in MODEL_NAMES},
            "turbo_max_abs_diff": {n: float(np.abs(tp.turbo_fns[n](x) - plain.turbo_fns[n](x)).max())
                                   for n in tp.turbo_fns},
            "bound": INT8_TP_BOUND,
            "paths": {e: {n: {k: p[k] for k in ("wall_p50_ms", "device_ms", "idle_share")}
                          for n, p in path_times(eng, x, ("diffusion", "hybrid")).items()}
                      for e, eng in (("int8_tp2", tp), ("int8_unsharded", plain))},
        })
    finally:
        tp.close()
    report["int8_tp"] = res
    print(json.dumps({"int8_tp": res}), flush=True)
    assert res["mesh_shape"] == {"dp": 1, "sp": 1, "tp": 2} and res["n_tp_sharded"] == TP2_SERVE_SHARDED, res
    assert res["int8_slices"] > 0 and res["slices_static_on_their_device"], res
    assert all(r == PER_REQUEST for r in res["launches_per_request"]), res["launches_per_request"]
    for key in ("max_abs_diff", "fused_max_abs_diff", "turbo_max_abs_diff"):
        assert max(res[key].values()) <= INT8_TP_BOUND, (key, res[key])
    return launched


def _max_abs(got: dict, want: dict) -> dict:
    return {n: float(np.abs(got[n] - want[n]).max()) for n in got}


def sp_serving_slice(report: dict, smi: str, unsharded: dict) -> dict:
    """Phase 19: the engine's ``spatial_parallel`` on the one card, SERVE_*
    widths, 512², TF32 off, seeded demo weights, against the unsharded
    engines of phases 17 and 18c (``unsharded``: "fp32" with fused requests
    and the turbo tier, "default", "int8"): (a) sp 2 (``devices=["cuda:0"]
    * 2``), fp32 evals, fused and turbo on: 3 requests through
    ``process_all`` (48 flash forward and 120 ln2d launches each, as
    unsharded: attention runs whole), the four paths', the fused and the
    turbo functions' outputs to ``SP_FP32_BOUND``, each path's wall and
    device time beside the unsharded engine's as phase 17 timed it (not a
    speed result: the blocks share the card); (b) on 4 slots, sp 2 × tp 2 (``n_tp_sharded``
    the JAX count, ``TP2_SERVE_SHARDED``) and dp 2 × sp 2 (a 2-row batch),
    fp32, one request each, to ``SP_FP32_BOUND``; (c) the server's ``--sp
    2`` configuration (bf16 UNet evals), which answers one request through
    the stdlib server, against the default engine (``TP_BF16_BOUND`` on the
    rollout paths); (d) ``--int8`` at sp 2 on the unsharded int8 engine's
    scales, one request, every path to ``INT8_TP_BOUND``; (e) ``sp_size=64``
    at 512² (the deepest map has 32 rows) raises the JAX engine's
    ``ValueError``. Returns each engine's requests' launches."""
    set_tf32(False)
    fp32 = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False, warmup=False)
    two, four = ["cuda:0"] * 2, ["cuda:0"] * 4
    pngs = [xray_png(512, 512, seed=7000 + i) for i in range(PARALLEL_REQUESTS)]
    x2 = np.concatenate([_png_array(png) for png in pngs[:2]])
    x = x2[:1]
    plain = unsharded["fp32"]
    want = {n: plain.fns[n](x) for n in MODEL_NAMES}
    res = {"card": smi, "note": "the sp blocks share one card: a correctness run, not a speed result"}
    launched = {}
    t = time.time()
    sp = InferenceEngine(EngineConfig(**fp32, fused_request=True, adaptive_turbo=True, spatial_parallel=True,
                                      sp_size=2), devices=two)
    res["engine_build_s"] = time.time() - t
    try:
        zero_counts()
        per_request = []
        for i, png in enumerate(pngs):
            before = counts()
            out = sp.process_all(_png_array(png), (512, 512))
            per_request.append(since(before))
            assert all(out[n] is not None for n in MODEL_NAMES), f"sp request {i}: a path answered null"
        launched["serve_sp"] = counts()
        res["sp"] = {"mesh_shape": sp.mesh_shape,
                     "row_split_layers": sum(isinstance(m, RowParallel) for m in sp.replicas[0]["unet_eval"].modules()),
                     "launches_per_request": per_request,
                     "max_abs_diff": _max_abs({n: sp.fns[n](x) for n in MODEL_NAMES}, want),
                     "fused_max_abs_diff": _max_abs(sp.fused(x), plain.fused(x)),
                     "turbo_max_abs_diff": {n: float(np.abs(sp.turbo_fns[n](x) - plain.turbo_fns[n](x)).max())
                                            for n in sp.turbo_fns},
                     "bound": SP_FP32_BOUND}
        res["sp"]["paths"] = {  # the unsharded engine's: phase 17's times of it, on an image of that phase
            "sp2": {n: {k: p[k] for k in ("wall_p50_ms", "device_ms", "idle_share", "peak_gib")}
                    for n, p in path_times(sp, x).items()},
            "unsharded": report["parallel_serving"]["tp"]["paths"]["unsharded"]}
    finally:
        sp.close()
    print(json.dumps({"sp_serving": res["sp"]}), flush=True)

    for key, flags, xin in (("sp_tp", dict(tensor_parallel=True, tp_size=2), x),
                            ("dp_sp", dict(data_parallel=True), x2)):
        eng = InferenceEngine(EngineConfig(**fp32, spatial_parallel=True, sp_size=2, **flags), devices=four)
        try:
            zero_counts()
            got = {n: eng.fns[n](xin) for n in MODEL_NAMES}
            launched[f"serve_{key}"] = counts()
            res[key] = {"mesh_shape": eng.mesh_shape, "n_tp_sharded": eng.n_tp_sharded,
                        "launches": launched[f"serve_{key}"],
                        "max_abs_diff": _max_abs(got, {n: plain.fns[n](xin) for n in MODEL_NAMES})}
        finally:
            eng.close()
        print(json.dumps({f"sp_serving_{key}": res[key]}), flush=True)

    _, cfg = server.config_from_args(["--sp", "2"])
    assert cfg.spatial_parallel and cfg.sp_size == 2, cfg
    eng = InferenceEngine(cfg, devices=two)  # on one card the server's own device list is one card: a no-op
    try:
        with serving(eng) as addr:
            zero_counts()
            status = post_status(addr, pngs[2], (512, 512))
            launched["serve_sp_server"] = counts()
        default = unsharded["default"]
        res["server_sp"] = {"mesh_shape": eng.mesh_shape, "status": status["status"],
                            "launches": launched["serve_sp_server"],
                            "max_abs_diff": _max_abs({n: eng.fns[n](x) for n in MODEL_NAMES},
                                                     {n: default.fns[n](x) for n in MODEL_NAMES}),
                            "bound": {"diffusion": TP_BF16_BOUND, "hybrid": TP_BF16_BOUND,
                                      "nafnet": SP_FP32_BOUND, "expert": SP_FP32_BOUND}}
    finally:
        eng.close()
    print(json.dumps({"sp_serving_server": res["server_sp"]}), flush=True)

    int8 = unsharded["int8"]
    with carried_scales(int8.int8_scales):
        eng = InferenceEngine(dataclasses.replace(int8.cfg, spatial_parallel=True, sp_size=2), devices=two)
    try:
        zero_counts()
        got = {n: eng.fns[n](x) for n in MODEL_NAMES}
        launched["serve_int8_sp"] = counts()
        res["int8_sp"] = {"mesh_shape": eng.mesh_shape, "launches": launched["serve_int8_sp"],
                          "max_abs_diff": _max_abs(got, {n: int8.fns[n](x) for n in MODEL_NAMES}),
                          "bound": INT8_TP_BOUND}
    finally:
        eng.close()
    print(json.dumps({"sp_serving_int8": res["int8_sp"]}), flush=True)

    try:
        InferenceEngine(EngineConfig(warmup=False, spatial_parallel=True, sp_size=64), devices=["cuda:0"] * 64)
        res["deepest_error"] = None
    except ValueError as e:
        res["deepest_error"] = str(e)
    report["sp_serving"] = res
    print(json.dumps({"sp_serving_checks": {k: res[k] for k in ("engine_build_s", "deepest_error")}}), flush=True)

    r = res["sp"]
    assert r["mesh_shape"] == {"dp": 1, "sp": 2, "tp": 1} and r["row_split_layers"] > 0, r
    assert all(n == PER_REQUEST for n in r["launches_per_request"]), r["launches_per_request"]
    for key in ("max_abs_diff", "fused_max_abs_diff", "turbo_max_abs_diff"):
        assert max(r[key].values()) <= SP_FP32_BOUND, (key, r[key])
    assert res["sp_tp"]["mesh_shape"] == {"dp": 1, "sp": 2, "tp": 2}, res["sp_tp"]
    assert res["sp_tp"]["n_tp_sharded"] == TP2_SERVE_SHARDED and res["sp_tp"]["launches"] == PER_REQUEST, res["sp_tp"]
    assert res["dp_sp"]["mesh_shape"] == {"dp": 2, "sp": 2, "tp": 1}, res["dp_sp"]
    assert res["dp_sp"]["launches"] == _launches(2 * PER_REQUEST["flash_fwd"], 2 * PER_REQUEST["ln2d"]), res["dp_sp"]
    for key in ("sp_tp", "dp_sp"):
        assert max(res[key]["max_abs_diff"].values()) <= SP_FP32_BOUND, (key, res[key])
    s = res["server_sp"]
    assert s["mesh_shape"] == {"dp": 1, "sp": 2, "tp": 1} and s["status"] == 200 and s["launches"] == PER_REQUEST, s
    assert all(s["max_abs_diff"][n] <= s["bound"][n] for n in MODEL_NAMES), s
    q = res["int8_sp"]
    assert q["launches"] == PER_REQUEST and max(q["max_abs_diff"].values()) <= INT8_TP_BOUND, q
    assert res["deepest_error"] == (
        "spatial_parallel sp=64 exceeds the deepest feature-map height 32 at img_size=512: some shards "
        "would be empty (wrong results under GSPMD). Lower sp_size."), res["deepest_error"]
    return launched


CPU_CHECKS = (card_vs_cpu, nafnet_card_vs_cpu, cddpm_rollout_card_vs_cpu, tiny_sample_card_vs_cpu,
              train_step_card_vs_cpu, nafnet_step_card_vs_cpu, expert_step_card_vs_cpu, hybrid_step_card_vs_cpu,
              cddpm_step_card_vs_cpu, tiny_step_card_vs_cpu, int8_card_vs_cpu)


# Phase 20: bench_train_torch.py --quick. Each model's step runs once untimed,
# --inner 8 x --reps 3 timed, then the 64-phantom pipeline at batch 2 (its
# warm-up batches and one epoch): 6 flash forward, dq and dk/dv launches a
# diffusion step, 60 ln2d a NAFNet step, and 60 more in the NAFNet count's
# forward (the counted model computes ln2d by its kernel; the diffusion one
# takes the exact attention)
BENCH_STEPS = 1 + 8 * 3 + bench_train_torch.WARMUP_BATCHES + 64 // 2
BENCH_LAUNCHES = {**NO_LAUNCHES, "flash_fwd": 6 * BENCH_STEPS, "flash_bwd_dq": 6 * BENCH_STEPS,
                  "flash_bwd_dkv": 6 * BENCH_STEPS, "ln2d": 60 * (BENCH_STEPS + 1)}
# the native resize against PIL: PIL rounds its fixed-point passes, the
# kernel its double-precision ones (the JAX bridge's documented bound)
NATIVE_PIL_LSB = 2
NATIVE_PAIRS, NATIVE_SRC, NATIVE_IMG = 16, 1024, 256


def flops_bench_native_slice(report: dict, smi: str) -> dict:
    """Phase 20: the FLOP counter on the card (bf16, the plain layout, 256²)
    against the JAX package's counts (``FLOPS_*``), ``device_peak_tflops``,
    ``bench_train_torch.py --quick`` (its launches held to
    ``BENCH_LAUNCHES``) and the native data path (g++ build, the 2048² ->
    512² resize against PIL, ``PairedXRayDataset`` with and without it on
    the loader's threads). Returns the bench's launches."""
    dev = torch.device("cuda")
    default_tf32()
    gen = torch.Generator().manual_seed(71)
    unet = init_weights(UNetDiffusion(config.SERVE_DIFFUSION, fuse_updown=False, use_flash=False), gen).to(dev)
    nafnet = init_weights(EnhancedNAFNet(config.SERVE_NAFNET), gen).to(dev)
    unet.compute_dtype = nafnet.compute_dtype = torch.bfloat16
    x = torch.rand(1, 1, 256, 256, generator=gen).to(dev)
    t = torch.full((1,), 500, dtype=torch.long, device=dev)
    t0 = time.time()
    with torch.no_grad():
        got = {"unet_forward": flops.count_flops(unet, x, x, t),
               "nafnet_forward": flops.count_flops(nafnet, x),
               "ddim50": flops.count_flops(denoise, unet, x, make_schedule(config.SERVE_SCHEDULE, "cuda"), 50)}
    peak = flops.device_peak_tflops()
    res = {"card": smi, "flops": got, "device_peak_tflops": peak, "counts_s": time.time() - t0}
    print(json.dumps({"flops_on_card": got, "device_peak_tflops": peak, "card": smi}), flush=True)
    assert got == {"unet_forward": FLOPS_UNET_FWD, "nafnet_forward": FLOPS_NAFNET_FWD, "ddim50": FLOPS_DDIM50}, got
    assert peak == PEAK_BF16_FLOPS / 1e12, peak

    # the training steps' counts are the bench's own (its step_flops, on the card)
    t0 = time.time()
    zero_counts()
    line = bench_train_torch.main(["--quick"])
    launched = counts()
    res["bench_train"] = {"line": line, "launches": launched, "s": time.time() - t0}
    assert launched == BENCH_LAUNCHES, (launched, BENCH_LAUNCHES)
    assert [(r["model"], r["img"], r["batch"]) for r in line["rows"]] == [("diffusion", 256, 2), ("nafnet", 256, 2)]
    for row in line["rows"]:
        assert np.isfinite(row["ms_per_step"]) and row["ms_per_step"] > 0 and 0 < row["mfu"] <= 1, row
    assert line["nvidia_smi"] == smi and line["peak_tflops_assumed"] == peak, line
    assert {r["model"]: r["model_tflop_per_step"] for r in line["rows"]} == {
        "diffusion": FLOPS_DIFFUSION_STEP / 1e12, "nafnet": FLOPS_NAFNET_STEP / 1e12}, line

    t_native = time.time()
    built_here = not native.library_path().exists()
    assert native.available(), native.error()
    nat = {"build_s": time.time() - t_native, "built_here": built_here, "library": native.library_path().name}
    img = (np.random.default_rng(81).random((2048, 2048)) * 255).astype(np.uint8)
    pil = np.asarray(Image.fromarray(img).resize((512, 512), Image.BICUBIC))
    out = native.resize_bicubic_u8(img, (512, 512))
    nat["max_lsb_vs_pil"] = int(np.abs(out.astype(int) - pil).max())
    assert out.shape == (512, 512) and nat["max_lsb_vs_pil"] <= NATIVE_PIL_LSB, nat
    nat["resize_ms"] = {"native": time_host_ms(lambda: native.resize_bicubic_u8(img, (512, 512))),
                        "pil": time_host_ms(lambda: Image.fromarray(img).resize((512, 512), Image.BICUBIC))}
    with tempfile.TemporaryDirectory() as root:
        dirs = write_pairs(root, NATIVE_PAIRS, NATIVE_SRC)
        before = os.environ.get("MIDD_TPU_NATIVE")
        loaded = {}
        try:
            for mode in ("0", "1"):
                os.environ["MIDD_TPU_NATIVE"] = mode
                ds = PairedXRayDataset(*dirs, img_size=NATIVE_IMG, is_train=False)
                t0 = time.perf_counter()
                loaded[mode] = np.concatenate([c for c, _ in batches(ds, 4, shuffle=False, num_workers=2)])
                nat[f"dataset_s_native_{mode}"] = time.perf_counter() - t0
        finally:
            if before is None:
                os.environ.pop("MIDD_TPU_NATIVE", None)
            else:
                os.environ["MIDD_TPU_NATIVE"] = before
    nat["dataset_max_abs_native_vs_pil"] = float(np.abs(loaded["1"] - loaded["0"]).max())
    assert loaded["1"].shape == (NATIVE_PAIRS, NATIVE_IMG, NATIVE_IMG, 1), loaded["1"].shape
    assert nat["dataset_max_abs_native_vs_pil"] <= NATIVE_PIL_LSB / 255 + 1e-7, nat
    nat["s"] = time.time() - t_native
    res["native"] = nat
    report["flops_bench_native"] = res
    print(json.dumps({"native": nat, "counts_s": res["counts_s"], "bench_s": res["bench_train"]["s"]}), flush=True)
    return launched


def time_host_ms(fn, reps: int = 5) -> float:
    """Median wall ms of a host call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# AOT-pinned serving (phase 22): 512², SERVE_* widths, the default engine.
# fp32 paths (nafnet, expert) within PERF.md §2's fp32 serving bound of eager
# with TF32 off (Inductor sums the norms and elementwise chains around the
# kernels in its own order); the bf16-eval rollouts (diffusion, hybrid) within
# their bound (Inductor keeps a fused kernel's bf16 intermediates in fp32).
# The cold start compiles for minutes on the host's cores, in a process of its
# own (``--aot-cold DIR``) that the script starts after the build and that
# runs beside phases 3-21; phase 22 waits for it at most AOT_COLD_WAIT_S more.
AOT_REQUESTS = 3
AOT_BOUNDS = {"nafnet": 1e-4, "expert": 1e-4, "diffusion": 5e-2, "hybrid": 5e-2}
AOT_COLD_WAIT_S = 900
AOT_COLD_ALONE_WAIT_S = 3000  # --aot-int8-only: 12 programs took 1974 s alone
AOT_SERVER_READY_S = 600


def aot_requests() -> list:
    rng = np.random.default_rng(22)
    return [rng.random((1, 512, 512, 1), dtype=np.float32) for _ in range(AOT_REQUESTS)]


def aot_engine_config(root: str) -> EngineConfig:
    return EngineConfig(aot_dir=os.path.join(root, "aot"), cache_dir=os.path.join(root, "cache"))


def aot_serve(engine: InferenceEngine, xs: list) -> tuple:
    """The seeded requests through every path of ``engine``: their outputs
    and each request's launches (``PER_REQUEST`` required)."""
    outs, per_request = [], []
    for x in xs:
        before = counts()
        outs.append({name: engine.fns[name](x) for name in MODEL_NAMES})
        per_request.append(since(before))
        assert per_request[-1] == PER_REQUEST, per_request[-1]
    return outs, per_request


def aot_cold_default(root: str) -> None:
    """Phase 22's cold start: ``EngineConfig()`` with ``aot_dir`` and
    ``cache_dir`` empty under ``root``, every pin compiled, the seeded
    requests served; writes ``cold.json`` (time to ready, pins, launches,
    dropped pins) and ``cold.npz`` (outputs) into ``root``."""
    t = time.time()
    engine = InferenceEngine(aot_engine_config(root))
    ready = time.time() - t
    try:
        outs, per_request = aot_serve(engine, aot_requests())
        np.savez(os.path.join(root, "cold.npz"),
                 **{f"{i}/{name}": out[name] for i, out in enumerate(outs) for name in MODEL_NAMES})
        record = {"ready_s": ready, "pins": engine.aot_report, "launches_per_request": per_request,
                  "dropped": engine.aot_dropped, "cores": len(os.sched_getaffinity(0)),
                  "workers": pin_workers(len(engine.aot_report))}
    finally:
        engine.close()
    write_json(os.path.join(root, "cold.json"), record)


def aot_cold_int8(root: str) -> None:
    """Phase 22b's cold start: the server's ``AOT_INT8_ARGS`` configuration
    with its ``aot_dir`` empty and the cache directory under ``root``, every
    pin compiled; writes ``cold_int8.json`` (time to ready, pins with each
    one's export and compile seconds, dropped pins, the calls each pin
    answered in the batcher's warm-up, the host's cores and the compile
    workers run at once) into ``root``."""
    t = time.time()
    engine = InferenceEngine(aot_int8_config(root))
    ready = time.time() - t
    try:
        record = {"ready_s": ready, "pins": engine.aot_report, "dropped": engine.aot_dropped,
                  "served_in_warmup": engine.aot_served, "cores": len(os.sched_getaffinity(0)),
                  "cpu_count": os.cpu_count(), "workers": pin_workers(len(AOT_INT8_PINS))}
    finally:
        engine.close()
    write_json(os.path.join(root, "cold_int8.json"), record)


# Phase 22's int8 product inside a pinned program, in every run: one static
# QuantConv2d at SERVE_DIFFUSION's first int8 convolution at 256² (48 -> 48
# channels, 3x3), batch 2. Its inputs are whole multiples of the activation
# step (act_absmax 127 * 2^-5: the step is 2^-5) and each output channel's
# weights whole multiples of its step (a largest |w| of 127 * 2^-6), so both
# quantisations are exact and any division gives the same integers; the
# int32 sums are exact, and the dequantisation multiplies by powers of two.
# So the program must equal eager bit for bit. Another scale through the
# state (127 * 2^-4) must change the output, with no recompile.
AOT_QCONV = (48, 48, 256, 2)  # in and out channels, size, batch
AOT_QCONV_ABSMAX = (127 * 2.0 ** -5, 127 * 2.0 ** -4)


def qconv_pin_module():
    """(module, example inputs) of phase 22's int8 product check
    (``AOT_QCONV``), seeded, its weights and scale in a packed state
    (``InferenceEngine._pack``) as the engine's pins take theirs, on the
    card."""
    c_in, c_out, size, batch = AOT_QCONV
    gen = torch.Generator().manual_seed(222)
    conv = qconv.QuantConv2d(c_in, c_out, 3, mode="static")
    with torch.no_grad():
        w = torch.randint(-127, 128, conv.weight.shape, generator=gen).float()
        w[:, 0, 0, 0] = 127.0  # each channel's largest |w|: its step is 2^-6
        conv.weight.copy_(w * 2.0 ** -6)
        conv.bias.copy_(torch.randint(-64, 65, conv.bias.shape, generator=gen).float() * 2.0 ** -6)
    qconv.load_qscales(conv, {"": torch.tensor(AOT_QCONV_ABSMAX[0])})
    models = torch.nn.ModuleDict({"conv": conv.cuda()})
    flats, layout = InferenceEngine._pack(
        {k: t.detach() for k, t in (*models.named_parameters(), *models.named_buffers())})
    x = (torch.randint(-127, 128, (batch, c_in, size, size), generator=gen).float() * 2.0 ** -5).cuda()
    return engine_module._Pinned(lambda a: models["conv"](a), models, layout), (flats, x)


def aot_qconv_check(report: dict, cold: dict) -> None:
    """Phase 22's int8 product inside a pinned program (``AOT_QCONV``):
    the pin the cold process compiled, loaded here, equal to eager bit for
    bit at two scales passed through the state, and its int8 GEMM kernels
    (by the profiler's kernel names) as many as eager's."""
    out = {"waited_s": aot_cold_wait(cold, "cold_qconv.json")}
    with open(os.path.join(cold["root"], "cold_qconv.json")) as f:
        out["cold"] = json.load(f)
    module, (flats, x) = qconv_pin_module()
    program = load_executable(os.path.join(cold["root"], "qconv.pt2"))
    key, off, _ = module.layout["conv.act_absmax"]
    outs = {}
    with torch.no_grad():
        for absmax in AOT_QCONV_ABSMAX:
            state = {**flats, key: flats[key].clone()}
            state[key][off] = absmax
            outs[absmax] = (module(state, x), program(state, x))
    torch.cuda.synchronize()
    names = int8_gemm_names(lambda: module(flats, x))
    runs = {side: kernel_runs(fn) for side, fn in (("eager", lambda: module(flats, x)),
                                                   ("pinned", lambda: program(flats, x)))}
    out.update(int8_gemm_kernels=sorted(names),
               int8_gemms={side: sum(c for k, c in r.items() if k in names) for side, r in runs.items()},
               bitwise_equal=[bool(torch.equal(e, p)) for e, p in outs.values()],
               max_abs_diff=[float((e - p).abs().max()) for e, p in outs.values()],
               scales_differ=not torch.equal(*(p for _, p in outs.values())))
    report["aot_qconv"] = out
    print(json.dumps({"aot_qconv": out}), flush=True)
    assert not out["cold"]["loaded"] and all(out["bitwise_equal"]) and out["scales_differ"], out
    assert out["int8_gemms"]["pinned"] == out["int8_gemms"]["eager"] >= 1, out


def aot_cold_qconv(root: str) -> None:
    """Phase 22's int8 product check, compiled cold in the cold process:
    ``qconv_pin_module`` pinned into ``root/qconv.pt2``; writes
    ``cold_qconv.json`` (its seconds)."""
    t = time.time()
    module, args = qconv_pin_module()
    _, loaded = pin_or_load(module, args, os.path.join(root, "qconv.pt2"))
    write_json(os.path.join(root, "cold_qconv.json"), {"secs": time.time() - t, "loaded": loaded})


AOT_COLD = {"default": aot_cold_default, "qconv": aot_cold_qconv, "int8": aot_cold_int8}


def write_json(path: str, record) -> None:
    with open(f"{path}.tmp", "w") as f:
        json.dump(record, f)
    os.replace(f"{path}.tmp", path)


def aot_cold_main(root: str, configs: str) -> int:
    """The cold starts (``--aot-cold DIR --aot-configs default,qconv``, a
    process the script starts after the build; ``int8`` for phase 22b's),
    one after another into DIR, sharing its compiler cache, with TF32 off.
    It runs niced, its compile workers too: the other phases keep the host's
    cores first (beside it at the same priority, phase 18's ranks took 1.5×
    as long)."""
    os.nice(10)
    set_tf32(False)
    for name in configs.split(","):
        AOT_COLD[name](root)
    return 0


def aot_cold_start(configs: str) -> dict:
    """Start the cold starts ``configs`` in a process of their own, into a
    new directory; its output goes to ``cold_<configs>.log`` there."""
    root = tempfile.mkdtemp(prefix="aot_")
    log_path = os.path.join(root, f"cold_{configs.replace(',', '_')}.log")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--aot-cold", root,
                                 "--aot-configs", configs],
                                stdout=log_file, stderr=subprocess.STDOUT)
    return {"root": root, "proc": proc, "log": log_path, "started": time.time()}


def aot_cold_wait(cold: dict, result: str) -> float:
    """Wait until the cold process has written ``result`` into its
    directory (at most ``cold["wait_s"]``, default ``AOT_COLD_WAIT_S``); the
    seconds waited. A cold process that failed, or ended or ran out of time
    without writing it, fails the phase."""
    t, path = time.time(), os.path.join(cold["root"], result)
    while not os.path.exists(path):
        code = cold["proc"].poll()
        log_tail = open(cold["log"]).read()[-4000:]
        assert code is None, f"the cold start ended ({code}) without {result}: {log_tail}"
        if time.time() - t > cold.get("wait_s", AOT_COLD_WAIT_S):
            aot_cold_stop(cold)
            raise AssertionError(f"the cold start did not write {result} in time: {log_tail}")
        time.sleep(1)
    return time.time() - t


def aot_cold_stop(cold: dict) -> None:
    proc = cold["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def aot_server_start(aot_dir: str, cache_dir: str, args=()) -> dict:
    """The server as a user starts it (``python -m
    midd_tpu_torch.serve.server --aot DIR`` and ``args``) in a new process
    on a free port, its output to ``server.log`` beside DIR."""
    port = free_port()
    log_path = os.path.join(os.path.dirname(aot_dir), f"server_{os.path.basename(aot_dir)}.log")
    env = {**os.environ, "MIDD_TPU_TORCH_CACHE_DIR": cache_dir}
    env.pop("TORCHINDUCTOR_CACHE_DIR", None)
    env.pop("TRITON_CACHE_DIR", None)
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "midd_tpu_torch.serve.server", "--aot", aot_dir, *args,
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=log_file,
            stderr=subprocess.STDOUT)
    return {"proc": proc, "addr": ("127.0.0.1", port), "log": log_path, "started": time.time()}


def aot_server_ready(srv: dict) -> float:
    """Wait until the server answers ``/health``; its seconds from start."""
    while True:
        if srv["proc"].poll() is not None:
            raise AssertionError(f"the --aot server exited ({srv['proc'].returncode}): "
                                 + open(srv["log"]).read()[-4000:])
        if time.time() - srv["started"] > AOT_SERVER_READY_S:
            raise AssertionError("the --aot server did not answer in time: " + open(srv["log"]).read()[-4000:])
        try:
            status, _ = http_json(srv["addr"], "GET", "/health")
            if status == 200:
                return time.time() - srv["started"]
        except OSError:
            pass
        time.sleep(1)


def aot_server_stop(srv: dict) -> list:
    """Stop the server; the JSON events of its log."""
    proc = srv["proc"]
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    events = []
    for line in open(srv["log"]):
        try:
            events.append(json.loads(line))
        except ValueError:
            continue
    return events


def aot_server_pins(events: list) -> dict:
    """The pins a server start loaded and compiled (its ``aot_load`` and
    ``aot_compile`` events), each load's seconds, and the seconds its
    engine took from the first pin to the last (its ``aot_ready`` event)."""
    loads = [e for e in events if e.get("event") == "aot_load"]
    return {"aot_load": sorted(f"{e['model']}_b{e['batch']}" for e in loads),
            "aot_compile": [f"{e['model']}_b{e['batch']}" for e in events if e.get("event") == "aot_compile"],
            "load_ms": {f"{e['model']}_b{e['batch']}": e.get("load_s") for e in loads},
            "aot_ready_s": [e["latency_ms"] / 1e3 for e in events if e.get("event") == "aot_ready"]}


def aot_server(report: dict, srv: dict, ready: float) -> None:
    """The server started as a user starts it (``python -m
    midd_tpu_torch.serve.server --aot DIR``, a new process: ``srv``) on a
    warm directory, answering ``/health`` ``ready`` seconds after its start
    at the latest: every pin loaded (its ``aot_load`` events; no
    ``aot_compile``), one request answered. Stops the server."""
    try:
        ms = post_denoise(srv["addr"], xray_png(512, 512, 21), (512, 512))
    finally:
        events = aot_server_stop(srv)
    report["server"] = {"ready_s": ready, "request_ms": ms, **aot_server_pins(events)}
    print(json.dumps({"aot_server": report["server"]}), flush=True)
    assert report["server"]["aot_load"] == sorted(f"{n}_b1" for n in MODEL_NAMES), report["server"]
    assert not report["server"]["aot_compile"], report["server"]


def aot_slice(report: dict, smi: str, cold: dict) -> dict:
    """Phase 22: AOT-pinned serving at 512², SERVE widths. The cold start
    (``aot_cold_main``, started after the build) compiled every pin into
    empty directories and served the seeded requests; here a second start
    loads every pin, and the eager engine serves beside it: the pinned
    engines bit-equal, each path within ``AOT_BOUNDS`` of eager (TF32 off),
    each pinned request making ``PER_REQUEST``'s launches (the kernels run
    inside the programs) and no pin dropped; the server with ``--aot``, in
    a new process started before the second start, loads every pin meanwhile
    and answers once the comparisons are done. Prints each start's time to
    ready and each path's wall, device ms and launches, pinned beside eager
    (facts, not gates; timed once the server is ready and idle). Returns the
    launches of the second start's requests."""
    out = {"nvidia_smi": smi}
    root = cold["root"]
    out["cold_waited_s"] = aot_cold_wait(cold, "cold.json")
    with open(os.path.join(root, "cold.json")) as f:
        out["cold"] = json.load(f)
    cold_outs = dict(np.load(os.path.join(root, "cold.npz")))
    print(json.dumps({"aot_cold": out["cold"], "waited_s": out["cold_waited_s"]}), flush=True)
    pins = out["cold"]["pins"]
    assert sorted(pins) == sorted(f"{n}_b1" for n in MODEL_NAMES), pins
    assert not any(p["loaded"] for p in pins.values()) and out["cold"]["dropped"] == 0, out["cold"]
    out["flash_host_us"] = flash_host_us()  # with the host to itself again
    print(json.dumps({"flash_host_us": out["flash_host_us"]}), flush=True)

    srv = aot_server_start(os.path.join(root, "aot"), os.path.join(root, "cache"))  # loads beside the comparisons
    set_tf32(False)
    xs = aot_requests()
    engines = {}
    try:
        for key, cfg in (("warm", aot_engine_config(root)), ("eager", EngineConfig())):
            t = time.time()
            engines[key] = InferenceEngine(cfg)
            out[key] = {"ready_s": time.time() - t, "pins": dict(engines[key].aot_report)}
            print(json.dumps({f"aot_{key}": out[key]}), flush=True)
        assert sorted(out["warm"]["pins"]) == sorted(pins), out["warm"]
        assert all(p["loaded"] for p in out["warm"]["pins"].values()), out["warm"]
        outs = {}
        for key, engine in engines.items():
            outs[key], out[f"{key}_launches_per_request"] = aot_serve(engine, xs)
        errs = {}
        for name in MODEL_NAMES:
            for i in range(AOT_REQUESTS):
                warm, eager = outs["warm"][i][name], outs["eager"][i][name]
                assert warm.shape == eager.shape == (1, 512, 512, 1) and np.isfinite(warm).all(), name
                assert np.array_equal(warm, cold_outs[f"{i}/{name}"]), f"{name}: the loaded pin differs from the compiled one"
            errs[name] = max(float(np.abs(outs["warm"][i][name] - outs["eager"][i][name]).max())
                             for i in range(AOT_REQUESTS))
        out["max_abs_err_vs_eager"] = errs
        out["dropped"] = engines["warm"].aot_dropped
        print(json.dumps({"aot_vs_eager": errs, "bounds": AOT_BOUNDS, "dropped": out["dropped"]}), flush=True)
        assert all(errs[n] <= AOT_BOUNDS[n] for n in MODEL_NAMES), errs
        assert out["dropped"] == 0, out["dropped"]
        launched = {k: sum(r[k] for r in out["warm_launches_per_request"]) for k in KERNEL_COUNTERS}
        server_ready = aot_server_ready(srv)  # idle from here, while the paths are timed
        default_tf32()
        keep = ("wall_ms", "wall_p50_ms", "device_ms", "idle_share", "launches")
        out["paths"] = {key: {name: {k: v for k, v in row.items() if k in keep}
                              for name, row in path_times(engine, xs[0]).items()}
                        for key, engine in engines.items()}
        print(json.dumps({"aot_paths": out["paths"]}), flush=True)
    except BaseException:
        aot_server_stop(srv)
        raise
    finally:
        for engine in engines.values():
            engine.close()
        engines.clear()
        torch.cuda.empty_cache()
    aot_server(out, srv, server_ready)
    report["aot"] = out
    return launched


# Phase 22b (``--aot-int8-only``): the server's ``--int8 --batching --buckets
# 1,2 --adaptive`` configuration at 256² (static int8 in the UNets; the size
# at which the engine batches by default), pinned: the four paths and the
# two turbo paths at batches 1 and 2, 12 programs, compiled cold in a niced
# process, loaded by a second start in this process and by the server in a
# new one. Pinned against eager on the same seeded inputs with TF32 off:
# nafnet and expert within AOT_BOUNDS; the int8 rollouts within phase 12's
# rollout gates (int8 is chaotic: a last-bit change of an fp32 sum flips a
# rounding, and Inductor sums the elementwise chains in its own order), as
# is each row of a pinned batch against the batch-1 pin (the fp32 paths:
# BATCH_VS_SINGLE_BOUND). The cold start does not fit the default run: 12
# programs took 1974 s alone on the card's host, and 6 (batch 2) had not
# finished 1430 s after they began beside phases 3-21 (PERF.md §6).
AOT_INT8_SIZE = 256
AOT_INT8_NAMES = (*MODEL_NAMES, "turbo@diffusion", "turbo@hybrid")
AOT_INT8_BUCKETS = (1, 2)
AOT_INT8_ARGS = ["--img-size", str(AOT_INT8_SIZE), "--int8", "--batching", "--buckets",
                 ",".join(map(str, AOT_INT8_BUCKETS)), "--adaptive"]
AOT_INT8_PINS = sorted(f"{n}_b{b}" for n in AOT_INT8_NAMES for b in AOT_INT8_BUCKETS)
AOT_INT8_ROLLOUTS = ("diffusion", "hybrid", "turbo@diffusion", "turbo@hybrid")
AOT_INT8_CLIENTS, AOT_INT8_PER_CLIENT = 12, 2  # phase 8b's adaptive cell's clients, at 256²
TURBO_BATCH = {**PER_REQUEST, "flash_fwd": 36}  # both rollouts at (0, 2, 7): 3 evals x 6 blocks each


def aot_int8_config(root: str) -> EngineConfig:
    """The server's ``AOT_INT8_ARGS`` configuration with ``--aot`` under
    ``root`` and the compiler cache that phase 22 shares."""
    _, cfg = server.config_from_args([*AOT_INT8_ARGS, "--aot", os.path.join(root, "aot_int8")])
    return dataclasses.replace(cfg, cache_dir=os.path.join(root, "cache"))


def _path_fn(engine: InferenceEngine, name: str):
    """The function of path ``name`` (``turbo@<path>`` for a turbo path):
    the pinned dispatch on an engine with ``aot_dir``, else the eager path."""
    table = engine._turbo_paths if name.startswith("turbo@") else engine._paths
    return table[name.split("@")[-1]]


def _on_engine(engine: InferenceEngine, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` on the engine's device thread under inference mode."""
    def run():
        with torch.inference_mode():
            out = fn(x)
        torch.cuda.synchronize()
        return out

    return engine._on_device_thread(run)


def _rollout_stats(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float().cpu().numpy().ravel(), b.float().cpu().numpy().ravel()
    return {"max_abs": float(np.abs(a - b).max()), "corr": float(np.corrcoef(a, b)[0, 1])}


def _within(name: str, stats: dict, fp32_bound: float) -> bool:
    if name in AOT_INT8_ROLLOUTS:
        return stats["max_abs"] < INT8_ROLLOUT_MAX and stats["corr"] > INT8_ROLLOUT_CORR
    return stats["max_abs"] <= fp32_bound


def kernel_runs(fn) -> dict:
    """Runs of each device kernel in one call of ``fn`` under the profiler
    (after ``_profile_once``'s pad), retaken up to 3 times while the profile
    is empty or lost a launch's record; raises if none is whole."""
    for _ in range(3):
        before = counts()
        _, calls, _, lost = _profile_once(fn)
        _restore_counts(before)
        if calls and not lost:
            return calls
    raise AssertionError("no whole profile of the call in 3 tries: its kernels cannot be counted")


def int8_gemm_names(run) -> set:
    """The device kernels of the int8 products: ``torch._int_mm``'s operands
    recorded through one eager ``run()``, then one product of each recorded
    shape and layout alone under the profiler; the names of the kernels
    those launch."""
    seen, int_mm = set(), torch._int_mm

    def recording(a, b):
        seen.add((tuple(a.shape), a.stride(), tuple(b.shape), b.stride()))
        return int_mm(a, b)

    torch._int_mm = recording
    try:
        run()
    finally:
        torch._int_mm = int_mm
    assert seen, "the eager int8 call ran no torch._int_mm"
    gen = torch.Generator(device="cuda").manual_seed(22)
    names = set()
    for a_shape, a_stride, b_shape, b_stride in sorted(seen):
        a = torch.empty_strided(a_shape, a_stride, dtype=torch.int8, device="cuda")
        b = torch.empty_strided(b_shape, b_stride, dtype=torch.int8, device="cuda")
        for t in (a, b):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda", dtype=torch.int8))
        names |= set(kernel_runs(lambda: int_mm(a, b)))
    return names


def aot_int8_launches(engines: dict, x2: np.ndarray) -> dict:
    """Launches of an exact batch (the four paths) and of a turbo batch (the
    turbo rollouts and the one-forward paths) at batch 2 on each engine, by
    the counters, and the int8 GEMM kernels of an exact batch, by the
    profiler's kernel names (``count_launch`` runs only while a program is
    traced, so it cannot count inside one)."""
    eager = engines["eager"]

    def exact_batch(engine):
        return lambda: [engine.fns[n](x2) for n in MODEL_NAMES]

    def turbo_batch(engine):
        return lambda: [(engine.turbo_fns if n in engine.turbo_fns else engine.fns)[n](x2) for n in MODEL_NAMES]

    names = int8_gemm_names(exact_batch(eager))
    out = {"int8_gemm_kernels": sorted(names)}
    for key, engine in engines.items():
        before, products = counts(), qconv.int8_conv2d.calls
        exact_batch(engine)()
        out[f"{key}_batch"] = since(before)
        out[f"{key}_batch_int8_products"] = qconv.int8_conv2d.calls - products
        before = counts()
        turbo_batch(engine)()
        out[f"{key}_turbo_batch"] = since(before)
        runs = kernel_runs(exact_batch(engine))
        out[f"{key}_batch_int8_gemms"] = sum(c for k, c in runs.items() if k in names)
        # the library kernels beside them (Inductor's own are named triton_*)
        out[f"{key}_batch_other_library_kernels"] = sum(
            c for k, c in runs.items() if _kind(k).startswith("conv / gemm") and k not in names
            and not k.startswith("triton"))
    return out


def aot_int8_times(engines: dict, xs: dict) -> dict:
    """Facts, not gates (default TF32): each path's wall p50 of 3 calls, one
    call's device ms under the profiler and the idle share, pinned beside
    eager, at each batch size."""
    default_tf32()
    out = {}
    for key, engine in engines.items():
        for name in AOT_INT8_NAMES:
            for b, x in xs.items():
                fn = _path_fn(engine, name)
                walls = []
                for _ in range(3):
                    t = time.perf_counter()
                    _on_engine(engine, fn, x)
                    walls.append((time.perf_counter() - t) * 1e3)
                by_kernel, _ = device_profile(lambda: _on_engine(engine, fn, x))
                wall, device = statistics.median(walls), sum(by_kernel.values())
                out.setdefault(key, {})[f"{name}_b{b}"] = {"wall_p50_ms": wall, "device_ms": device,
                                                           "idle_share": 1.0 - device / wall}
    return out


def aot_int8_load(srv: dict) -> dict:
    """The adaptive cell at 256²: ``AOT_INT8_CLIENTS`` closed-loop clients of
    ``AOT_INT8_PER_CLIENT`` seeded requests each against the ``--aot``
    server; its batcher's counts and what each pin served during it
    (``/health``'s ``batching`` and ``aot``)."""
    status, before = http_json(srv["addr"], "GET", "/health")
    assert status == 200 and "aot" in before and "batching" in before, before
    pngs = [[xray_png(AOT_INT8_SIZE, AOT_INT8_SIZE, seed=2200 + AOT_INT8_PER_CLIENT * c + i)
             for i in range(AOT_INT8_PER_CLIENT)] for c in range(AOT_INT8_CLIENTS)]
    load = client_load(srv["addr"], pngs, (AOT_INT8_SIZE, AOT_INT8_SIZE))
    _, after = http_json(srv["addr"], "GET", "/health")
    served = {name: {b: n - before["aot"]["served"][name].get(b, 0) for b, n in per_batch.items()}
              for name, per_batch in after["aot"]["served"].items()}
    stats = {k: after["batching"][k] - before["batching"][k] for k in ("requests", "batches", "turbo_batches")}
    return {**{k: v for k, v in load.items() if k != "answers"},
            "statuses": sorted({a["status"] for a in load["answers"]}), "served": served,
            "served_in_warmup": before["aot"]["served"], **stats,
            "mean_batch": stats["requests"] / max(stats["batches"], 1), "aot_dropped": after["aot"]["dropped"]}


def aot_int8_slice(report: dict, smi: str, cold: dict) -> dict:
    """Phase 22b (see the module docstring). The cold start (``aot_cold_int8``,
    in the cold process started after the build) compiled the programs into an empty
    directory; here the server starts on it in a new process while a second
    start in this process loads every pin and an eager engine of the same
    configuration sits beside it (each calibrates its own scales on the same
    seeded batches, TF32 off): the scales agree, every program is called on
    a seeded 256² batch against eager and against its rows alone, a pinned
    exact and turbo batch make the eager one's launches and int8 GEMM
    kernels; then the server serves the adaptive cell with no pin dropped,
    its exact and turbo programs answering. Walls, device ms and idle
    shares, pinned beside eager, are printed last. Returns the launches of
    both engines' batches."""
    root = cold["root"]
    out = {"nvidia_smi": smi, "cold_waited_s": aot_cold_wait(cold, "cold_int8.json")}
    with open(os.path.join(root, "cold_int8.json")) as f:
        out["cold"] = json.load(f)
    pins = out["cold"]["pins"]
    print(json.dumps({"aot_int8_cold": {
        "ready_s": out["cold"]["ready_s"], "cores": out["cold"]["cores"], "cpu_count": out["cold"]["cpu_count"],
        "workers": out["cold"]["workers"],
        "pins": {k: {f: p.get(f) for f in ("queued_s", "worker_s", "build_s", "export_s", "compile_s",
                                            "peak_device_mb", "phases")} for k, p in pins.items()}}}), flush=True)
    assert sorted(pins) == AOT_INT8_PINS, sorted(pins)
    assert not any(p["loaded"] for p in pins.values()) and out["cold"]["dropped"] == 0, out["cold"]
    cfg = aot_int8_config(root)
    srv = aot_server_start(cfg.aot_dir, cfg.cache_dir, AOT_INT8_ARGS)  # loads beside the comparisons
    engines = {}
    try:
        set_tf32(False)
        for key, c in (("warm", cfg), ("eager", dataclasses.replace(cfg, aot_dir=None))):
            t = time.time()
            engines[key] = InferenceEngine(c)
            out[key] = {"ready_s": time.time() - t, "calibration_ms": engines[key].calibration_ms,
                        "pins": {k: p.get("load_s") for k, p in engines[key].aot_report.items()}}
            print(json.dumps({f"aot_int8_{key}": out[key]}), flush=True)
        warm, eager = engines["warm"], engines["eager"]
        assert sorted(warm.aot_report) == AOT_INT8_PINS, sorted(warm.aot_report)
        assert all(p["loaded"] for p in warm.aot_report.values()), warm.aot_report
        assert set(warm.int8_scales) == set(eager.int8_scales) == {"diffusion", "hybrid"}, eager.int8_scales
        out["int8_scales_max_rel_diff"] = max(
            abs(warm.int8_scales[m][n].item() - eager.int8_scales[m][n].item()) / eager.int8_scales[m][n].item()
            for m in eager.int8_scales for n in eager.int8_scales[m])

        rng = np.random.default_rng(221)
        x2 = torch.from_numpy(rng.random((2, 1, AOT_INT8_SIZE, AOT_INT8_SIZE), dtype=np.float32)).cuda()
        rows = (x2[:1].contiguous(), x2[1:].contiguous())
        served0 = warm.aot_served
        errs = {}
        for name in AOT_INT8_NAMES:
            pinned, eager2 = (_on_engine(e, _path_fn(e, name), x2) for e in (warm, eager))
            # each row alone: the batch-1 pin where there is one, else the engine's eager fallback
            singles = torch.cat([_on_engine(warm, _path_fn(warm, name), r) for r in rows])
            assert pinned.shape == (2, 1, AOT_INT8_SIZE, AOT_INT8_SIZE) and torch.isfinite(pinned).all(), name
            errs[name] = {"b2_vs_eager": _rollout_stats(pinned, eager2), "b2_vs_rows_alone": _rollout_stats(pinned, singles)}
        served = {n: {b: c - served0[n].get(b, 0) for b, c in d.items()} for n, d in warm.aot_served.items()}
        out.update(vs_eager=errs, served_by_direct_calls=served, dropped=warm.aot_dropped)
        print(json.dumps({"aot_int8_vs_eager": errs, "int8_scales_max_rel_diff": out["int8_scales_max_rel_diff"],
                          "served_by_direct_calls": served, "dropped": out["dropped"],
                          "bounds": {"fp32": AOT_BOUNDS["nafnet"], "batch_vs_single": BATCH_VS_SINGLE_BOUND,
                                     "int8_rollout_max": INT8_ROLLOUT_MAX, "int8_rollout_corr": INT8_ROLLOUT_CORR,
                                     "int8_absmax_rel": INT8_ABSMAX_REL}}), flush=True)
        assert out["int8_scales_max_rel_diff"] <= INT8_ABSMAX_REL, out["int8_scales_max_rel_diff"]
        assert all(served[n] == {b: 2 if b == 1 else 1 for b in AOT_INT8_BUCKETS} for n in AOT_INT8_NAMES), served
        for name, e in errs.items():
            assert _within(name, e["b2_vs_eager"], AOT_BOUNDS.get(name, 0.0)), (name, e)
            assert _within(name, e["b2_vs_rows_alone"], BATCH_VS_SINGLE_BOUND), (name, e)

        zero_counts()
        out["launches"] = aot_int8_launches(engines, x2.permute(0, 2, 3, 1).cpu().numpy())
        launched = counts()  # both engines' batches, eager's included: the kernels ran in both
        print(json.dumps({"aot_int8_launches": out["launches"]}), flush=True)
        lz = out["launches"]
        for key in engines:
            assert lz[f"{key}_batch"] == PER_REQUEST, (key, lz)
            assert lz[f"{key}_turbo_batch"] == TURBO_BATCH, (key, lz)
        assert lz["eager_batch_int8_products"] > 0 and lz["warm_batch_int8_products"] == 0, lz
        assert lz["warm_batch_int8_gemms"] == lz["eager_batch_int8_gemms"] >= lz["eager_batch_int8_products"], lz
        assert warm.aot_dropped == 0, warm.aot_dropped

        out["server_ready_s"] = aot_server_ready(srv)
        out["load"] = aot_int8_load(srv)
        events = aot_server_stop(srv)
        out["server"] = aot_server_pins(events)
        print(json.dumps({"aot_int8_server": {"ready_s": out["server_ready_s"], **out["server"]},
                          "aot_int8_load": out["load"]}), flush=True)
        assert out["server"]["aot_load"] == AOT_INT8_PINS and not out["server"]["aot_compile"], out["server"]
        ld = out["load"]
        assert ld["n_ok"] == ld["n"] == AOT_INT8_CLIENTS * AOT_INT8_PER_CLIENT and ld["statuses"] == [200], ld
        assert ld["aot_dropped"] == 0 and ld["turbo_batches"] > 0 and ld["mean_batch"] > 1, ld
        assert ld["served"]["diffusion"]["2"] > 0 and ld["served"]["turbo@diffusion"]["2"] > 0, ld
        out["paths"] = aot_int8_times(engines, {b: rows[0] if b == 1 else x2 for b in AOT_INT8_BUCKETS})
    finally:
        for engine in engines.values():
            engine.close()
        if srv["proc"].poll() is None:
            aot_server_stop(srv)
        torch.cuda.empty_cache()
    print(smi, flush=True)
    print(json.dumps({"aot_int8_paths": out["paths"]}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    report["aot_int8"] = out
    return launched


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None,
                    help="also profile a request and a training step and write a JSON report here")
    ap.add_argument("--naf-only", action="store_true",
                    help="run only the device and build phases and phases 6 and 7 (an A/B of the "
                         "NAFNet kernels); prints no result line")
    ap.add_argument("--dp-rank", default=None, metavar="JOB",
                    help="(the ranks of phase 18's torchrun launches) run JOB's recipes; prints no result line")
    ap.add_argument("--aot-cold", default=None, metavar="DIR",
                    help="(phases 22 and 22b's cold starts, run by the script) pin into DIR; prints no "
                         "result line")
    ap.add_argument("--aot-configs", default="default,qconv",
                    help="(with --aot-cold) the cold starts to run, in order: default and qconv (phase 22), "
                         "int8 (22b)")
    ap.add_argument("--aot-int8-only", action="store_true",
                    help="run only the device and build phases and phase 22b; prints no result line")
    args = ap.parse_args(argv)
    t_all = time.time()
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if args.dp_rank:
        return dp_rank_main(args.dp_rank)
    if args.aot_cold:
        return aot_cold_main(args.aot_cold, args.aot_configs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}

    phase("build")
    t = time.time()
    libraries = {fa.SOURCE: fa._SIGNATURES[fa.SOURCE], fa.BWD_SOURCE: fa._SIGNATURES[fa.BWD_SOURCE],
                 ln.SOURCE: ln._SIGNATURES, ffn.SOURCE: ffn._SIGNATURES}
    if args.naf_only:  # phase 7's module forward runs ln2d
        libraries = {ln.SOURCE: ln._SIGNATURES, ffn.SOURCE: ffn._SIGNATURES}
    if args.aot_int8_only:  # the served kernels
        libraries = {fa.SOURCE: fa._SIGNATURES[fa.SOURCE], ln.SOURCE: ln._SIGNATURES}
    cpu_checks = () if args.naf_only or args.aot_int8_only else CPU_CHECKS
    with ThreadPoolExecutor(max_workers=len(libraries) + 1) as pool:  # one nvcc per source, all at once
        cpu_sides = pool.submit(prefetch_cpu_sides, cpu_checks)  # the CPU halves of phases 9, 10, 12c meanwhile
        for lib in pool.map(lambda src: _build.build(src, verbose=True), libraries):
            print(lib, flush=True)
        report["build_s"] = time.time() - t
        report["cpu_sides_s"] = cpu_sides.result()
    for source, signatures in libraries.items():
        _build.library(source, signatures)
    print(json.dumps({"build_s": report["build_s"], "cpu_sides_s": report["cpu_sides_s"],
                      "both_s": time.time() - t}), flush=True)

    if args.naf_only:
        phase("naf_ffn kernel vs plain")
        entry = check_naf_ffn(report)
        phase("slice: nafnet_apply_fused at 512²")
        entry["launches"] = fused_forward(report, profile=True)["naf_ffn"]
        report["kernels"] = [entry]
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1)
        print(json.dumps({"total_s": time.time() - t_all, "profiler": PROFILER}), flush=True)
        print(json.dumps({"kernels": [entry]}), flush=True)
        return 0

    if args.aot_int8_only:
        cold_int8 = {**aot_cold_start("int8"), "wait_s": AOT_COLD_ALONE_WAIT_S}
        atexit.register(aot_cold_stop, cold_int8)
        phase(f"slice: the pinned {' '.join(AOT_INT8_ARGS)} server ({len(AOT_INT8_PINS)} programs)")
        t = time.time()
        aot_int8_slice(report, smi, cold_int8)
        print(json.dumps({"phase_22b_s": time.time() - t, "total_s": time.time() - t_all}), flush=True)
        return 0

    # phase 22's cold start compiles beside phases 3-21 (stopped at exit if it still runs)
    cold = aot_cold_start("default,qconv")
    atexit.register(aot_cold_stop, cold)

    phase("forward kernel vs plain")
    entries = [check_kernel(report)]

    phase("backward kernels vs plain")
    entries += check_bwd(report)

    phase("ln2d kernel vs plain")
    entries.append(check_ln2d(report))

    phase("naf_ffn kernel vs plain")
    entries.append(check_naf_ffn(report))

    # the main paths, each driven with the counts set to 0 just before it
    paths = {}
    phase("slice: nafnet_apply_fused at 512²")
    paths["nafnet_apply_fused"] = fused_forward(report, profile=args.report is not None)

    phase("slice: 512² /denoise through the port's server")
    paths["serve"] = serve_slice(report, profile=args.report is not None)

    phase("slice: batched, adaptive and fused serving, and the inference and evaluate CLIs")
    t = time.time()
    paths["serve_batched"] = batched_serving(report)
    paths["serve_adaptive"] = adaptive_serving(report)
    paths["serve_fused"] = fused_serving(report, profile=args.report is not None)
    paths["cli"] = cli_slice(report)
    report["phase_8b_s"] = time.time() - t
    print(json.dumps({"phase_8b_s": report["phase_8b_s"]}), flush=True)
    if args.report:
        report["batching_report"] = batching_report()

    phase("card vs CPU")
    card_vs_cpu(report)
    nafnet_card_vs_cpu(report)
    cddpm_rollout_card_vs_cpu(report)
    tiny_sample_card_vs_cpu(report)

    phase("one training step, card vs CPU")
    train_step_card_vs_cpu(report)
    nafnet_step_card_vs_cpu(report)
    expert_step_card_vs_cpu(report)
    hybrid_step_card_vs_cpu(report)
    cddpm_step_card_vs_cpu(report)
    tiny_step_card_vs_cpu(report)

    phase("slice: training through recipes.main at 512², then serving its checkpoint")
    with tempfile.TemporaryDirectory() as keep_dir:  # the hybrid's backends
        paths["train_diffusion"] = train_slice(report, smi, keep_dir)
        paths["train_nafnet"] = nafnet_train_slice(report, smi, keep_dir)
        paths["train_expert"] = expert_train_slice(report, smi)
        paths["train_hybrid"] = hybrid_train_slice(report, smi, keep_dir)
    paths["train_cddpm"] = cddpm_train_slice(report, smi)
    paths["train_tiny"] = tiny_train_slice(report, smi)
    if args.report:
        report["train_step_profile"] = profile_train_step("diffusion")
        report["nafnet_train_step_profile"] = profile_train_step("nafnet")
        report["expert_train_step_profile"] = profile_train_step("expert")
        report["hybrid_train_step_profile"] = profile_train_step("hybrid")
        report["cddpm_train_step_profile"] = profile_train_step("cddpm")
        report["tiny_train_step_profile"] = profile_train_step("tiny")

    phase("slice: int8 serving (--int8) at 512²")
    t = time.time()
    paths["serve_int8"], int8_scales = int8_serving(report, int8_products(report))
    int8_card_vs_cpu(report)
    report["phase_12_s"] = time.time() - t

    phase("slice: the 1024² operating point at full width")
    t = time.time()
    paths["serve_1024"] = serve_1024(report)
    report["phase_13_s"] = time.time() - t

    phase("slice: MODEL2_NAFNET at 512²")
    t = time.time()
    model2_kernels(report)
    paths["model2_fused"] = model2_slice(report)
    report["phase_14_s"] = time.time() - t
    print(json.dumps({k: report[k] for k in ("phase_12_s", "phase_13_s", "phase_14_s")}), flush=True)

    phase("slice: the xraybench-v1 quality benchmark at serve widths, 256²")
    t = time.time()
    paths["xraybench"], _ = xray_bench_slice(report, smi)
    report["phase_15_s"] = time.time() - t
    print(json.dumps({"phase_15_s": report["phase_15_s"]}), flush=True)

    phase("slice: rematerialisation at 512²")
    t = time.time()
    paths["remat"] = remat_slice(report, smi)
    report["phase_16_s"] = time.time() - t
    print(json.dumps({"phase_16_s": report["phase_16_s"]}), flush=True)

    unsharded = {}  # phases 17 and 18c's unsharded engines, which phase 19 holds its engines to
    try:
        phase("slice: tensor- and data-parallel serving on the one card at 512²")
        t = time.time()
        torch.cuda.empty_cache()
        paths.update(parallel_serving_slice(report, smi, unsharded))
        report["phase_17_s"] = time.time() - t
        print(json.dumps({"phase_17_s": report["phase_17_s"]}), flush=True)

        phase("slice: training under torchrun at 512² (dp 2, tp 2, dp 2 x tp 2, sp 2, dp 2 x sp 2, "
              "sp 2 x tp 2, dp 2 x sp 2 x tp 2; phases 16b, 18a-b, 19b and 21 in three launches), "
              "and int8 under tp")
        t = time.time()
        torch.cuda.empty_cache()  # the ranks share the card
        trained, paths["serve_int8_tp"] = parallel_training_slice(
            report, smi, lambda: int8_tp_slice(report, smi, unsharded, int8_scales))
        paths.update(trained)
        report["phase_18_s"] = time.time() - t
        print(json.dumps({"phase_18_s": report["phase_18_s"]}), flush=True)

        phase("slice: spatial-parallel serving on the one card at 512²")
        t = time.time()
        paths.update(sp_serving_slice(report, smi, unsharded))
        report["phase_19_s"] = time.time() - t
        print(json.dumps({"phase_19_s": report["phase_19_s"]}), flush=True)
    finally:
        for engine in unsharded.values():
            engine.close()

    phase("slice: the FLOP counter, bench_train_torch.py --quick and the native data path")
    t = time.time()
    torch.cuda.empty_cache()
    paths["bench_train"] = flops_bench_native_slice(report, smi)
    report["phase_20_s"] = time.time() - t
    if args.report:
        report["bench_step_profile"] = {m: profile_bench_step(m) for m in bench_train_torch.QUICK}
    print(json.dumps({"phase_20_s": report["phase_20_s"]}), flush=True)

    phase("slice: AOT-pinned serving at 512² (compiled beside phases 3-21, loaded, and through the server's --aot), "
          "and the int8 product in a pinned program")
    t = time.time()
    paths["serve_aot"] = aot_slice(report, smi, cold)
    aot_qconv_check(report, cold)
    shutil.rmtree(cold["root"], ignore_errors=True)
    report["phase_22_s"] = time.time() - t
    print(json.dumps({"phase_22_s": report["phase_22_s"]}), flush=True)


    for entry in entries:
        by_path = {p: launched[entry["name"]] for p, launched in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was never launched on the main paths")
    report["kernels"] = entries
    report["total_s"] = time.time() - t_all
    report["profiler"] = {k: v for k, v in PROFILER.items() if k != "off"}
    report["profile_dumps"] = PROFILE_DUMPS
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"total_s": report["total_s"], "build_s": report["build_s"], "profiler": report["profiler"]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
