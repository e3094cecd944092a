"""The port's kernel builder: what names a built library, and the launch
seam every kernel goes through (no nvcc needed)."""

import collections
import ctypes
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
    assert _build.sources() == ["bn_relu", "flash_absorb", "lstm_cell",
                                "probe_chain", "swiglu"]


def test_host_libraries_build_with_cc_under_a_hash_of_their_sources(
        csrc, tmp_path, monkeypatch):
    """A host library (csrc/*.c) builds with the C compiler at first use,
    into the build directory under a hash of its sources, every csrc/*.h
    and the flags; an edited header builds it anew, and nvcc's list of
    sources never shows it."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "HOST_LIBRARIES", {"host": ("host.c",)})
    (csrc / "host.c").write_text(
        '#include "host.h"\nint f(void) { return N; }\n')
    (csrc / "host.h").write_text("#define N 1\n")
    first = _build.host_library("host")
    assert os.path.basename(first).startswith("libhost-")
    assert os.path.exists(first) and _build.host_library("host") == first
    (csrc / "host.h").write_text("#define N 2\n")
    second = _build.host_library("host")
    assert second != first and os.path.exists(second)
    assert _build.sources() == ["kern"]


class _FakeLibrary:
    """A kernel library's stand-in: its entry ``vtpu_fake`` records its
    arguments and returns ``err``."""

    def __init__(self, err: int):
        self.calls = []

        def entry(*args):
            self.calls.append(args)
            return err
        self.vtpu_fake = entry

    def vtpu_error_string(self, err: int) -> bytes:
        return b"fake failure"


@pytest.fixture
def fake_kernel(monkeypatch):
    """A :class:`_build.Kernel` over a fake library on stream 0xbeef,
    with an empty launch count of its own."""
    monkeypatch.setattr(_build, "_stream", lambda on: 0xbeef)
    monkeypatch.setattr(_build, "launches", collections.Counter())

    def make(err: int):
        lib = _FakeLibrary(err)
        monkeypatch.setitem(_build._LIBS, "fake", lib)
        return lib, _build.Kernel("fake", "vtpu_fake", [ctypes.c_int] * 2)
    return make


def test_kernel_passes_the_stream_last_and_counts_a_launch(fake_kernel):
    lib, kernel = fake_kernel(0)
    kernel(object(), 3, 4)
    assert lib.calls == [(3, 4, 0xbeef)]
    assert lib.vtpu_fake.argtypes == [ctypes.c_int] * 2 + [ctypes.c_void_p]
    assert lib.vtpu_fake.restype is ctypes.c_int
    assert _build.launches == {"fake": 1}


def test_kernel_raises_on_an_error_with_its_name_and_counts_nothing(
        fake_kernel):
    lib, kernel = fake_kernel(700)
    with pytest.raises(RuntimeError,
                       match=r"^fake: CUDA error 700 \(fake failure\)"):
        kernel(object(), 3, 4)
    with pytest.raises(RuntimeError, match=r"^fake \(ring\): CUDA error"):
        kernel(object(), 3, 4, label="fake (ring)")
    assert len(lib.calls) == 2 and not _build.launches
