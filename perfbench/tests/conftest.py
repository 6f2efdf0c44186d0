import dataclasses
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


def tiny(cell, size=64):
    """A cell cut to what a CPU test run holds: 64x64, two clients (or one
    request a second), six uploads, two answers checked; widths as
    published, limits as the cell's."""
    wl = dict(cell.workload, uploads=6, check=2)
    if wl["kind"] == "closed_loop":
        wl["params"] = dict(wl["params"], clients=2, warmup_rounds=1)
    else:
        wl["params"] = dict(wl["params"], rate_per_s=1.0, warmup_requests=2)
    args = ["--img-size", str(size)] + (["--batching", "--buckets", "1,2"] if "--batching" in
                                        cell.config["server_args"] else [])
    return dataclasses.replace(cell, workload=wl, config=dict(cell.config, img_size=size, server_args=args))


@pytest.fixture
def tiny_cell():
    from perfbench import harness

    return lambda name, root=ROOT: tiny(harness.load_cell(root, name))
