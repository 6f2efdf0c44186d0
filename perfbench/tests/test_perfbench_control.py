"""The comparison that decides ``correct`` fails what it must: the control
(the program's own lower-precision paths, ``readings.CONTROL_ARGS``) and a
run whose timed path is broken underneath, each on a cut cell with the
cell's own limits. On the CPU the harness skips its look for a card; the
``cuda`` cases run the same on the card. The exchange between chips is no
fault these one-card cells can have."""

import dataclasses
import time

import pytest
import torch

from perfbench import faults, harness, readings

SEED = 2**31 + 2**29 + 17


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return name


def _run(cell, device, **kw):
    return harness.run_cell(cell, SEED, 4.0, False, time.monotonic(), device=device, **kw)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("name", ["xray512_b8.closed16", "xray1024.closed3"])
def test_sound_run_is_correct_and_the_control_is_not(tiny_cell, name, device):
    cell = tiny_cell(name)
    assert _run(cell, _device(device))["correct"]
    control = _run(cell, device, extra_server_args=readings.CONTROL_ARGS)
    assert not control["correct"], control["checks"]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("fault,cells", [
    ("state_unchanged", ["xray512_b8.closed16", "xray1024.closed3"]),
    ("half_batch", ["xray512_b8.closed16"]),
    ("answer_altered", ["xray512_b8.closed16", "xray1024.closed3"]),
    ("hybrid_altered", ["xray512_b8.closed16", "xray1024.closed3"]),
])
def test_a_broken_timed_path_is_not_correct(tiny_cell, fault, cells, device):
    _device(device)
    for name in cells:
        cell = tiny_cell(name)
        cell = dataclasses.replace(cell, workload=dict(cell.workload, check=6))
        res = _run(cell, device, fault=faults.FAULTS[fault])
        assert not res["correct"], (name, res["checks"])
        if fault == "state_unchanged" and "hybrid_rollout" in cell.workload["limits"]:
            assert res["checks"]["hybrid_rollout_off2_pct"]["value"] > cell.workload["limits"]["hybrid_rollout"]
        if fault == "hybrid_altered" and "hybrid_fusion" in cell.workload["limits"]:
            assert res["checks"]["hybrid_fusion_off2_pct"]["value"] > cell.workload["limits"]["hybrid_fusion"]


def test_the_hybrid_is_followed_from_its_own_rollout(tiny_cell):
    """The 1024x1024 cell holds its hybrid in two stages: every checked
    answer's hybrid call is found, and a sound run reads both stages within
    their limits; the fault undoes itself after the run."""
    from midd_tpu_torch.serve import engine as eng

    denoise = eng.denoise
    cell = tiny_cell("xray1024.closed3")
    res = _run(cell, "cpu")
    assert res["correct"], res["checks"]
    assert {"hybrid_rollout_off2_pct", "hybrid_fusion_off2_pct"} <= set(res["checks"])
    assert res["load"]["levels"]["hybrid_fusion"]["ge2"] < 100.0
    _run(cell, "cpu", fault=faults.FAULTS["state_unchanged"])
    assert eng.denoise is denoise and eng.hybrid_forward.__module__ == "midd_tpu_torch.models.hybrid"
