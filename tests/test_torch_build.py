"""The port's kernel builder: what names a built library (no nvcc needed)."""

import os

import pytest

from k8s_device_plugin_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    return tmp_path


def test_target_changes_when_a_shared_header_changes(csrc):
    before = _build._target("kern")
    assert _build._target("kern") == before  # stable while nothing changes
    (csrc / "common.cuh").write_text("// v2\n")
    assert _build._target("kern") != before


def test_target_changes_with_the_source_a_new_header_and_the_flags(
        csrc, monkeypatch):
    seen = {_build._target("kern")}
    (csrc / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    seen.add(_build._target("kern"))
    (csrc / "other.cuh").write_text("// new\n")
    seen.add(_build._target("kern"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    seen.add(_build._target("kern"))
    assert len(seen) == 4


def test_headers_are_not_built_on_their_own(csrc):
    assert _build.sources() == ["kern"]
    assert os.path.basename(_build._target("kern")).startswith("libkern-")


def test_the_shipped_sources_are_the_three_kernels():
    assert _build.sources() == ["flash_absorb", "lstm_cell", "probe_chain"]
