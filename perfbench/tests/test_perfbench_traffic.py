"""Seeded, data-driven traffic: the same seed gives the same uploads, sizes
and arrivals, and every seed the same amount of work; a cell added by files
alone is found by name and runs; the harness and the reference load no JAX
and no JAX package, the reference nothing of the port, and the load
generator nothing beyond the standard library and numpy."""

import hashlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from perfbench import harness, inputs
from perfbench.tests.conftest import ROOT, tiny

SEED = 2**31 + 2**30 + 5


def test_same_seed_same_inputs():
    assert inputs.plan(SEED, 64, 512) == inputs.plan(SEED, 64, 512)
    assert inputs.upload(SEED, 3, 128, 8) == inputs.upload(SEED, 3, 128, 8)
    assert inputs.gaps(SEED, 5.5, 40) == inputs.gaps(SEED, 5.5, 40)
    assert inputs.upload(SEED, 3, 128, 8) != inputs.upload(SEED + 1, 3, 128, 8)


def test_every_seed_the_same_work():
    a, b = inputs.plan(SEED, 64, 512), inputs.plan(SEED + 1, 64, 512)
    assert a != b
    assert sorted(w for w, _, _ in a) == sorted(w for w, _, _ in b) == sorted(h for _, h, _ in b)
    assert sorted(f for _, _, f in a) == sorted(f for _, _, f in b)
    assert all(384 <= s <= 640 for w, h, _ in a for s in (w, h))
    ga, gb = inputs.gaps(SEED, 5.5, 40), inputs.gaps(SEED + 1, 5.5, 40)
    assert ga != gb and sorted(ga) == sorted(gb) and len(ga) == 220 and sum(ga) < 40


def test_png_round_trip():
    img = inputs.noisy_image(np.random.default_rng(1), 97, 61, "poisson")
    decoded = np.asarray(Image.open(io.BytesIO(inputs.png(img))))
    assert decoded.shape == (61, 97) and np.array_equal(decoded, (img * 255).astype(np.uint8))


def _digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted((root / "perfbench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.update((root / "BENCHMARK.json").read_bytes()) or h.hexdigest()


def test_a_cell_added_by_files_alone(tmp_path):
    before = _digest(ROOT)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "xray512_b8.closed2", "config": "xray512_b8", "traffic": "closed2",
                               "chips": 1, "why": "two callers"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = dict(json.loads((ROOT / "perfbench/workloads/xray512_b8.closed16.json").read_text()),
              traffic="closed2", params={"clients": 2, "warmup_rounds": 1}, why="two callers")
    (tmp_path / "perfbench/workloads/xray512_b8.closed2.json").write_text(json.dumps(wl))

    cell = harness.load_cell(tmp_path, "xray512_b8.closed2")
    assert cell.workload["params"]["clients"] == 2 and cell.config["img_size"] == 512
    assert {m["name"] for m in cell.end_to_end} == {"req_per_s", "latency_p50_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"shell_ms"}  # the metrics that list no cells
    res = harness.run_cell(tiny(cell), SEED, 3.0, False, time.monotonic(), device="cpu")
    assert res["correct"] and res["attempted"] >= 1 and set(res["metrics"]) == {"req_per_s", "latency_p50_ms",
                                                                                  "setup_s"}
    assert _digest(ROOT) == before


def _loaded(*modules) -> set:
    code = "import sys; " + "".join(f"import {m}; " for m in modules) + \
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    return set(subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout.split())


def test_what_the_harness_loads():
    everything = _loaded("perfbench.harness", "perfbench.checks", "perfbench.yardstick", "perfbench.weights",
                         "perfbench.readings", "perfbench.faults", "midd_tpu_torch.serve.server")
    assert not everything & set(harness.FORBIDDEN) and "midd_tpu_torch" in everything
    reference = _loaded("perfbench.reference.models", "perfbench.reference.serve", "perfbench.checks",
                        "perfbench.weights", "perfbench.yardstick")
    assert "midd_tpu_torch" not in reference and not reference & set(harness.FORBIDDEN)
    loadgen = _loaded("perfbench.loadgen", "perfbench.traffic.closed_loop", "perfbench.traffic.open_loop")
    assert loadgen - _loaded("sys") - set(sys.stdlib_module_names) == {"numpy", "perfbench"}


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    assert "midd_tpu" not in harness._forbidden()
    monkeypatch.setitem(sys.modules, "midd_tpu", types.ModuleType("midd_tpu"))
    assert harness._forbidden() == ["midd_tpu"]


def _copy_with(tmp_path, bench_edit, files) -> Path:
    """A copy of the benchmark with ``BENCHMARK.json`` edited and extra
    files, and a fake ``jax`` package under ``tmp_path/fake``."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench_edit(bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for rel, text in files.items():
        (root / rel).write_text(text)
    (tmp_path / "fake" / "jax").mkdir(parents=True)
    (tmp_path / "fake" / "jax" / "__init__.py").write_text("")
    return root


def test_a_reader_that_loads_jax_refuses_the_run(tmp_path):
    fake = tmp_path / "fake"
    reader = f"import sys\n\n\ndef read(run):\n    sys.path.insert(0, {str(fake)!r})\n    import jax  # noqa\n    return 1.0\n"
    root = _copy_with(tmp_path, lambda b: b["end_to_end"].append(
        {"name": "loads_jax", "unit": "1", "better": "lower", "bound": 0.25, "source": "host_clock"}),
        {"perfbench/metrics/loads_jax.py": reader})
    assert "jax" not in harness._forbidden()
    try:
        with pytest.raises(harness.ForbiddenModules, match="server's process"):
            harness.run_cell(tiny(harness.load_cell(root, "xray512_b8.closed16")), SEED, 2.0, False,
                             time.monotonic(), device="cpu")
    finally:
        sys.modules.pop("jax", None)
        sys.path.remove(str(fake))


def test_a_traffic_kind_that_loads_jax_refuses_the_run(tmp_path):
    fake = tmp_path / "fake"
    kind = (f"import sys\n\nsys.path.insert(0, {str(fake)!r})\nimport jax  # noqa\n"
            "from perfbench.traffic.closed_loop import run, warm  # noqa\n")
    wl = dict(json.loads((ROOT / "perfbench/workloads/xray512_b8.closed16.json").read_text()), kind="loads_jax")
    root = _copy_with(tmp_path, lambda b: None, {"perfbench/traffic/loads_jax.py": kind,
                                                 "perfbench/workloads/xray512_b8.closed16.json": json.dumps(wl)})
    with pytest.raises(harness.ForbiddenModules, match=r"\['jax'\] in the load generator's"):
        harness.run_cell(tiny(harness.load_cell(root, "xray512_b8.closed16")), SEED, 2.0, False,
                         time.monotonic(), device="cpu")
    assert "jax" not in harness._forbidden()


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "xray512_b8.closed16", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "xray512_b8.closed16", "--seed",
                          str(SEED), "--seconds", "5", "--trace", "1"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and 0 < res["device"]["busy_s"]
    assert all(0 < m["value"] <= 100 for k, m in res["metrics"].items() if k.endswith("roofline") or k == "mfu")


def test_open_loop_times_from_due(tiny_cell):
    import dataclasses

    cell = tiny_cell("xray512_b8.closed16")
    cell = dataclasses.replace(cell, workload=dict(cell.workload, kind="open_loop",
                                                   params={"rate_per_s": 1.0, "warmup_requests": 2}))
    res = harness.run_cell(cell, SEED, 4.0, False, time.monotonic(), device="cpu")
    assert res["correct"] and res["attempted"] == 4 and res["load"]["traffic"]["offered"] == 4
    assert res["metrics"]["latency_p50_ms"]["value"] > 0
