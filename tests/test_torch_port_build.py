"""The kernels' build cache (``bndm_tpu_torch/ops/_build.py``), on the CPU.

A library is named by a hash of what it is built from. These tests point
``CSRC`` at a temporary directory and check the names alone: no nvcc runs.
"""

import os

import pytest

from bndm_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    for name, text in (("a.cu", '#include "core.cuh"\n'), ("b.cu", "int b;\n"),
                       ("core.cuh", "int core;\n")):
        (tmp_path / name).write_text(text)
    return tmp_path


def test_lib_path_is_the_same_for_the_same_bytes(csrc):
    assert _build.lib_path("a") == _build.lib_path("a")
    assert _build.lib_path("a") != _build.lib_path("b")
    assert os.path.dirname(_build.lib_path("a")) == _build.BUILD_DIR


@pytest.mark.parametrize("edit", ["a.cu", "core.cuh", "new.cuh"])
def test_lib_path_changes_with_its_source_or_any_header(csrc, edit):
    """A change to the source, to a header it includes, or a new header in
    csrc/ names another library, so a stale build is never loaded."""
    before = _build.lib_path("a")
    path = csrc / edit
    path.write_text((path.read_text() if path.exists() else "") + "// changed\n")
    assert _build.lib_path("a") != before


def test_lib_path_ignores_another_source(csrc):
    before = _build.lib_path("a")
    (csrc / "b.cu").write_text("int b2;\n")
    assert _build.lib_path("a") == before


def test_sources_are_the_cu_files_not_the_headers(csrc):
    assert _build.sources() == ["a", "b"]


def test_the_ports_kernels_and_their_shared_core():
    """csrc/ holds three kernel sources; the 3xTF32 core is a header that
    K1 and K2 both include."""
    assert _build.sources() == ["fused_bluenoise", "stream_dma", "tri_matmul"]
    for name in ("tri_matmul", "fused_bluenoise"):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            assert '#include "tri_mma.cuh"' in f.read()
