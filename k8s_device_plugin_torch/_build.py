"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` for ``sm_90a``; the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header builds anew and an unchanged one is reused. Sources
build in parallel, one ``nvcc`` each. Nothing is built when this module is
imported: the first launch of a kernel (or an explicit :func:`build_all`)
builds it. :func:`set_build_dir` moves the libraries elsewhere (the compile
cache, ``workloads/harness.setup_compile_cache``) before the first load.
A :class:`Kernel` is the one way the wrappers launch a C entry: it loads
the library, passes the current stream, raises on an error and counts the
launch in :data:`launches`; :func:`query` calls an entry that launches
nothing.

The host libraries (``csrc/*.c``, :data:`HOST_LIBRARIES`: the enforcement
shim, the shared region's primitives, the mock driver) build the same way
with the C compiler, at first use (:func:`host_library`), into the same
directory under a hash of their sources, every ``csrc/*.h`` and the flags.
They need no CUDA toolkit. nvcc never sees them.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                                 "kernels")
#: where the libraries are built and looked for (see :func:`set_build_dir`)
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: host libraries: name -> their C sources in ``csrc``. ``vtpu_cuda`` is
#: the enforcement shim (LD_PRELOAD), ``vtpu_shm`` the shared region's
#: primitives without the shim (``shm/region.py`` loads it), ``cuda_mock``
#: a CUDA driver test double; ``vtpu_image.c`` reads what a loaded image
#: puts on a device, for the shim and the mock alike
HOST_LIBRARIES = {
    "vtpu_cuda": ("vtpu_cuda_preload.c", "vtpu_shm.c", "vtpu_image.c"),
    "vtpu_shm": ("vtpu_shm.c",),
    "cuda_mock": ("mock_cuda.c", "vtpu_image.c"),
}
CC_FLAGS = ("-std=gnu11", "-O2", "-g", "-Wall", "-Wextra", "-fPIC", "-shared")
CC_LIBS = ("-ldl", "-lpthread")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: launches on a card since the last ``launches.clear()``, by name: each
#: :class:`Kernel`'s under :attr:`Kernel.name`, and the model paths that
#: the card's checks count (``short_conv``, ``expert_apply``) under theirs
launches: collections.Counter = collections.Counter()


def set_build_dir(path: str | None = None) -> str:
    """Build and look for the libraries under ``path`` from now on (None:
    ``build/kernels`` beside the package); returns the directory. A
    library already loaded stays loaded: its name carries its hash, so it
    is the one the new directory would hold."""
    global BUILD_DIR
    BUILD_DIR = path or DEFAULT_BUILD_DIR
    return BUILD_DIR


def sources() -> list[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _hashed(name: str, files: list[str], header_ext: str,
            flags: tuple) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR)
                     if f.endswith(header_ext))
    for fname in [*files, *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _target(name: str) -> str:
    """The library path for ``name``: its hash covers ``<name>.cu``, every
    ``*.cuh`` beside it (any source may include any of them) and the
    flags."""
    return _hashed(name, [f"{name}.cu"], ".cuh", NVCC_FLAGS)


def _host_target(name: str) -> str:
    """The host library path for ``name``: its hash covers its sources,
    every ``*.h`` in ``csrc`` and the flags."""
    return _hashed(name, list(HOST_LIBRARIES[name]), ".h",
                   CC_FLAGS + CC_LIBS)


def _cc() -> str:
    for cand in ("cc", "gcc", "clang"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C compiler found: the host libraries build with "
                       "cc")


def host_library(name: str) -> str:
    """The path of host library ``name`` (:data:`HOST_LIBRARIES`), built
    with the C compiler if it has no current build. Raises with the
    compiler's output when the build fails."""
    with _LOCK:
        out = _host_target(name)
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_cc(), *CC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC_DIR, f) for f in HOST_LIBRARIES[name]),
               *CC_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cc failed for {name} (rc={proc.returncode})"
                               f":\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
        return out


def check_cuda_abi() -> str:
    """Compile ``csrc/cuda_abi_check.c`` against the toolkit's ``cuda.h``
    (under ``$CUDA_HOME``, default ``/usr/local/cuda``): it
    static-asserts that ``cuda_driver_abi.h`` declares every type, enum
    value, struct field and prototype as the toolkit does. Returns the
    header's path; raises with the compiler's output on a mismatch."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    header = os.path.join(home, "include", "cuda.h")
    if not os.path.exists(header):
        raise RuntimeError(f"no cuda.h under {home}")
    proc = subprocess.run(
        [_cc(), "-std=gnu11", "-fsyntax-only",
         "-I", os.path.join(home, "include"),
         os.path.join(CSRC_DIR, "cuda_abi_check.c")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("cuda_driver_abi.h differs from the toolkit's "
                           f"cuda.h:\n{proc.stdout}{proc.stderr}")
    return header


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source that has no current library, all at
    once; returns ``{name: ptxas report}`` (empty for a reused library).
    Raises with nvcc's output when a build fails."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def _library(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_target(name))
            lib.vtpu_error_string.argtypes = [ctypes.c_int]
            lib.vtpu_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err:
        msg = lib.vtpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def query(library: str, entry: str, argtypes: list, *args) -> None:
    """Call the C entry ``entry`` of ``csrc/<library>.cu`` that launches
    nothing (a question about the device, answered through pointer
    arguments): loads the library, passes no stream, raises through
    :func:`check` and counts nothing."""
    lib = _library(library)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    check(lib, fn(*args), entry)


def _stream(on) -> int:
    """The current raw CUDA stream of tensor ``on``'s device."""
    import torch
    return torch._C._cuda_getCurrentRawStream(on.get_device())


class Kernel:
    """The C entry ``entry`` of ``csrc/<library>.cu``. It returns a CUDA
    error code and takes ``argtypes`` (``c_void_p`` for every pointer, so
    ctypes never cuts one to 32 bits), then the stream.

    ``kernel(on, *args, label=None)`` builds and loads the library at the
    first call, launches with ``args`` on the current stream of tensor
    ``on``'s device, raises through :func:`check` (the message names
    ``label``, default :attr:`name`) and, once the entry returned
    success, counts one launch in :data:`launches` under :attr:`name`:
    ``name`` if given (two handles of one entry that launch kernels of
    their own names), else ``entry`` without its ``vtpu_`` prefix."""

    def __init__(self, library: str, entry: str, argtypes: list,
                 name: str | None = None):
        self.library = library
        self.entry = entry
        self.name = name or entry.removeprefix("vtpu_")
        self._argtypes = [*argtypes, ctypes.c_void_p]
        self._lib = self._fn = None

    def __call__(self, on, *args, label: str | None = None) -> None:
        if self._fn is None:
            lib = _library(self.library)
            fn = getattr(lib, self.entry)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        check(self._lib, self._fn(*args, _stream(on)), label or self.name)
        launches[self.name] += 1
