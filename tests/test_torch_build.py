"""The kernel libraries' names: ``kernels/_build.py:library_path``.

A library is named by a hash of its source, every header of ``csrc/`` and
the nvcc flags, so that an edit to any of them builds a new library and a
stale one is never loaded. Runs on a copy of ``csrc/`` (no nvcc needed).
"""

import shutil

import pytest

from fft_conv_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernels' sources that ``_build`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_follows_the_headers(csrc, name):
    """Every source's library path changes when a header's bytes change, and
    comes back when they do."""
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["bf16_mma.cuh", "tc_mac.cuh"]
    before = _build.library_path(name)
    assert before.parent == _build.BUILD_DIR and before.name.startswith(f"lib{name}-")
    for header in headers:
        text = header.read_bytes()
        header.write_bytes(text + b"\n// an edit\n")
        assert _build.library_path(name) != before
        header.write_bytes(text)
        assert _build.library_path(name) == before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_follows_the_source_and_a_new_header(csrc, name):
    before = _build.library_path(name)
    source = csrc / f"{name}.cu"
    source.write_bytes(source.read_bytes() + b"\n")
    edited = _build.library_path(name)
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) not in (before, edited)
