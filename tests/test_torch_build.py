"""The kernels' build names: a library's file name hashes its source, the
``csrc/`` headers that source includes (transitively) and the flags, so
an edit to any of them builds a new library and a stale one is never
loaded.  Runs on a copy of ``csrc/`` with ``nvcc`` stubbed: nothing is
compiled."""
import shutil

import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads in place of the real one,
    plus a second header that ``hopper.cuh`` includes."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    (copy / "inner.cuh").write_text("#pragma once\n")
    hopper = copy / "hopper.cuh"
    hopper.write_text('#include "inner.cuh"\n' + hopper.read_text())
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    return copy


def _name(source: str) -> str:
    return _build._command(source)[1].name


@pytest.mark.parametrize("edited, changes", [
    ("flash_attention.cu", {"flash_attention"}),
    ("hopper.cuh", {"decode_attention", "flash_attention", "mamba_scan",
                    "mla_decode"}),
    ("inner.cuh", {"decode_attention", "flash_attention", "mamba_scan",
                   "mla_decode"}),
    ("mamba_scan.cu", {"mamba_scan"}),
    ("unused.cuh", set()),
])
def test_library_name_covers_included_headers(csrc, edited, changes):
    """Editing a source, a header it includes or a header included by
    that header renames exactly the libraries built from it; a header no
    source includes renames none."""
    before = {name: _name(name) for name in _build.EXTRA_FLAGS}
    path = csrc / edited
    path.write_text((path.read_text() if path.exists() else "")
                    + "\n// edited\n")
    after = {name: _name(name) for name in _build.EXTRA_FLAGS}
    assert {n for n in before if before[n] != after[n]} == changes


def test_library_name_covers_flags(csrc, monkeypatch):
    """A flag of one source renames that source's library alone."""
    before = {name: _name(name) for name in _build.EXTRA_FLAGS}
    monkeypatch.setitem(_build.EXTRA_FLAGS, "decode_attention",
                        ["-lineinfo"])
    after = {name: _name(name) for name in _build.EXTRA_FLAGS}
    assert {n for n in before if before[n] != after[n]} == \
        {"decode_attention"}
