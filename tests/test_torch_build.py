"""The name of a built kernel library (``midd_tpu_torch/ops/_build.py::tag``)
follows everything its source compiles from: an edited ``.cuh`` header
beside the source must give a new library, or the loader would take a stale
one. Runs on a copy of ``csrc/`` and needs no ``nvcc``."""

import shutil

import pytest

from midd_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


def test_tag_depends_on_content_not_place(csrc):
    for source in _build.CSRC.glob("*.cu"):
        assert _build.tag(csrc / source.name) == _build.tag(source)


def test_edited_header_changes_the_tag(csrc):
    source = csrc / "flash_fwd.cu"
    before = _build.tag(source)
    header = csrc / "flash_mma.cuh"
    assert '#include "flash_mma.cuh"' in source.read_text()
    header.write_text(header.read_text() + "// edited\n")
    assert _build.tag(source) != before


@pytest.mark.parametrize("edit", ["source", "other_source", "new_header"])
def test_tag_follows_its_own_inputs(csrc, edit):
    source = csrc / "flash_bwd.cu"
    before = _build.tag(source)
    if edit == "source":
        source.write_text(source.read_text() + "\n")
    elif edit == "other_source":
        (csrc / "ln2d.cu").write_text((csrc / "ln2d.cu").read_text() + "\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    assert (_build.tag(source) != before) == (edit != "other_source")
