"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` for ``sm_90a``; the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header builds anew and an unchanged one is reused. Sources build in parallel, one ``nvcc`` each.
Nothing is built when this module is imported: the first launch of a
kernel (or an explicit :func:`build_all`) builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def _target(name: str) -> str:
    """The library path for ``name``: its hash covers ``<name>.cu``, every
    ``*.cuh`` beside it (any source may include any of them) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


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


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built on first use.

    Its entry point ``vtpu_<name>`` returns a CUDA error code and takes
    ``argtypes`` (``c_void_p`` for every pointer and stream, so ctypes
    never cuts one to 32 bits)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_target(name))
            entry = getattr(lib, f"vtpu_{name}")
            entry.argtypes = argtypes
            entry.restype = ctypes.c_int
            lib.vtpu_error_string.argtypes = [ctypes.c_int]
            lib.vtpu_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err:
        msg = lib.vtpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
