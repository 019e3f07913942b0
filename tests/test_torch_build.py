"""The kernel build's cache key: ``repro_torch.kernels._build.library_path``.

A library is named by a hash of every file under its source's ``csrc/``
directory and of the nvcc flags, so an edited header beside a source is
rebuilt rather than loaded stale. ``library_path`` only hashes, so these
tests need no nvcc and no card.
"""

from pathlib import Path

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops


@pytest.fixture
def csrc(tmp_path):
    root = tmp_path / "csrc"
    root.mkdir()
    (root / "kernel.cu").write_text('#include "helpers.cuh"\n__global__ void k() {}\n')
    (root / "helpers.cuh").write_text("#pragma once\nconstexpr int kTile = 128;\n")
    return root


def test_path_is_stable_while_nothing_changes(csrc):
    source = csrc / "kernel.cu"
    first = _build.library_path(source)
    assert first == _build.library_path(source)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libkernel-") and first.suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "new header", "source", "rename"])
def test_path_changes_when_a_file_beside_the_source_changes(csrc, edit):
    source = csrc / "kernel.cu"
    before = _build.library_path(source)
    if edit == "header":
        (csrc / "helpers.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    elif edit == "new header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    elif edit == "source":
        source.write_text(source.read_text() + "// edited\n")
    else:
        (csrc / "helpers.cuh").rename(csrc / "helpers2.cuh")
    assert _build.library_path(source) != before


def test_path_changes_with_the_flags(csrc, monkeypatch):
    source = csrc / "kernel.cu"
    before = _build.library_path(source)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path(source) != before


def test_path_ignores_files_outside_the_source_directory(csrc):
    source = csrc / "kernel.cu"
    before = _build.library_path(source)
    (csrc.parent / "unrelated.cuh").write_text("#pragma once\n")
    assert _build.library_path(source) == before


def test_kernel_sources_hash_their_own_directory():
    assert ops.SOURCE.parent.name == "csrc"
    assert isinstance(_build.library_path(ops.SOURCE), Path)

