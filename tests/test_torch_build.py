"""The cache key of the kernel build (``kubetpu_torch/ops/_build.py``): a
library's file name hashes its ``.cu`` source and every shared ``.cuh``
header, so an edit to either is never served from a stale build. Nothing
is compiled here."""

import pytest

from kubetpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "tiles.cuh"\n')
    (tmp_path / "tiles.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_editing_a_header_changes_the_library_path(csrc):
    first = _build._lib_path("kern")
    assert first == _build._lib_path("kern")         # stable
    (csrc / "tiles.cuh").write_text("// v2\n")
    second = _build._lib_path("kern")
    assert second != first
    assert second.parent == _build.BUILD_DIR
    assert second.name.startswith("libkern-") and second.suffix == ".so"


@pytest.mark.parametrize("edit", ["source", "new_header", "rename_header"])
def test_every_input_of_the_build_moves_the_path(csrc, edit):
    first = _build._lib_path("kern")
    if edit == "source":
        (csrc / "kern.cu").write_text('#include "tiles.cuh"\n// edited\n')
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// another\n")
    else:
        (csrc / "tiles.cuh").rename(csrc / "tiles2.cuh")
    assert _build._lib_path("kern") != first
