"""Python mirror of the shared-region ABI (``csrc/vtpu_shm.h``, the port's
copy of lib/tpu/vtpu_shm.h).

A copy of ``k8s_device_plugin_tpu/shm/region.py`` for the port, which
imports nothing of that package and loads no library of it. The monitor
reads (and writes feedback into) the same mmap the in-container shim
maintains; this ctypes layout must match the C struct bit-for-bit —
``tests/test_torch_shm.py`` holds it field by field against the JAX
package's mirror, and ``tests/test_torch_enforce.py`` against
``vtpu_abi_dump`` built on both C headers.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import mmap
import os
import threading

# POSIX record locks are per-process AND per-file, so the in-process guard
# must be shared by every Region instance open on the same file — a
# per-instance lock would let a second instance's LOCK_UN drop the
# process's file lock mid-critical-section. Keyed by realpath; entries are
# tiny and never removed (one per distinct cache file this process touches).
_FILE_LOCKS: dict[str, threading.Lock] = {}
_FILE_LOCKS_MU = threading.Lock()


def _file_thread_lock(path: str) -> threading.Lock:
    key = os.path.realpath(path)
    with _FILE_LOCKS_MU:
        lock = _FILE_LOCKS.get(key)
        if lock is None:
            lock = _FILE_LOCKS[key] = threading.Lock()
        return lock

VTPU_SHM_MAGIC = 0x56545055
VTPU_SHM_VERSION = 2  # v2: shared duty-cycle bucket appended
MAX_DEVICES = 16
MAX_PROCS = 256
MEM_KINDS = 4

KIND_CONTEXT, KIND_MODULE, KIND_BUFFER, KIND_OFFSET = range(4)
KIND_NAMES = ["context", "module", "buffer", "offset"]


class RegionNotReady(Exception):
    """The cache file exists but its region is not (yet) initialized."""


class DeviceMemory(ctypes.Structure):
    _fields_ = [
        ("kinds", ctypes.c_uint64 * MEM_KINDS),
        ("total", ctypes.c_uint64),
    ]


class ProcSlot(ctypes.Structure):
    _fields_ = [
        ("pid", ctypes.c_int32),
        ("hostpid", ctypes.c_int32),
        ("used", DeviceMemory * MAX_DEVICES),
        ("monitor_used", ctypes.c_uint64 * MAX_DEVICES),
        ("status", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


#: v1 layout (no duty-bucket tail) — readers keep mapping live v1 regions
#: written by not-yet-upgraded shims during rolling upgrades
class SharedRegionV1(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint32),
        ("version", ctypes.c_uint32),
        ("sem", ctypes.c_uint32),
        ("init_done", ctypes.c_uint32),
        ("num_devices", ctypes.c_uint64),
        ("limit", ctypes.c_uint64 * MAX_DEVICES),
        ("sm_limit", ctypes.c_uint64 * MAX_DEVICES),
        ("procs", ProcSlot * MAX_PROCS),
        ("last_kernel_time", ctypes.c_int64),
        ("utilization_switch", ctypes.c_int32),
        ("recent_kernel", ctypes.c_int32),
        ("priority", ctypes.c_int32),
        ("oversubscribe", ctypes.c_int32),
    ]


class SharedRegion(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint32),
        ("version", ctypes.c_uint32),
        ("sem", ctypes.c_uint32),
        ("init_done", ctypes.c_uint32),
        ("num_devices", ctypes.c_uint64),
        ("limit", ctypes.c_uint64 * MAX_DEVICES),
        ("sm_limit", ctypes.c_uint64 * MAX_DEVICES),
        ("procs", ProcSlot * MAX_PROCS),
        ("last_kernel_time", ctypes.c_int64),
        ("utilization_switch", ctypes.c_int32),
        ("recent_kernel", ctypes.c_int32),
        ("priority", ctypes.c_int32),
        ("oversubscribe", ctypes.c_int32),
        # v2: the shared duty-cycle token bucket (mutate under locked())
        ("duty_tokens_us", ctypes.c_int64 * MAX_DEVICES),
        ("duty_refill_us", ctypes.c_uint64 * MAX_DEVICES),
    ]


def _find_native_shm() -> ctypes.CDLL | None:
    """Load the shared region's primitives without the shim's constructor:
    ``VTPU_SHM_LIB`` when set (a prebuilt library), else the port's own
    build of ``csrc/vtpu_shm.c`` (``_build.host_library("vtpu_shm")``,
    built with the C compiler at first use). None when neither loads.

    Gives Python access to the same pid-owner sem lock the C shim takes, so
    slot claiming in :meth:`Region.attach` is atomic across both languages.
    """
    path = os.environ.get("VTPU_SHM_LIB")
    if not path:
        from .. import _build
        try:
            path = _build.host_library("vtpu_shm")
        except RuntimeError:  # no C compiler, or the build failed
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.vtpu_shm_lock.argtypes = [ctypes.c_void_p]
        lib.vtpu_shm_lock.restype = None
        lib.vtpu_shm_unlock.argtypes = [ctypes.c_void_p]
        lib.vtpu_shm_unlock.restype = None
        return lib
    except (OSError, AttributeError):
        return None  # unloadable, or a .so missing the lock symbols


_NATIVE_SHM: ctypes.CDLL | None = None
_NATIVE_SHM_TRIED = False


def _native_shm() -> ctypes.CDLL | None:
    global _NATIVE_SHM, _NATIVE_SHM_TRIED
    if not _NATIVE_SHM_TRIED:
        _NATIVE_SHM = _find_native_shm()
        _NATIVE_SHM_TRIED = True
    return _NATIVE_SHM


class Region:
    """mmap-backed view over a cache file (creates + inits when absent).

    Concurrency contract (mirrors the C side, ``csrc/vtpu_shm.c``):

    * init is guarded by a POSIX record lock on the cache file — the same
      lock family ``vtpu_shm_open`` holds — so a Python init can never race
      a C init and wipe a freshly initialized region;
    * :meth:`attach`/:meth:`detach` hold the file lock (vs other Python
      processes) *and*, when the region's primitives load
      (:func:`_find_native_shm`), the in-region pid-owner sem lock (vs C
      shim processes), making slot claiming atomic across
      implementations.
    """

    def __init__(self, path: str, create: bool = True):
        exists = os.path.exists(path) and \
            os.path.getsize(path) >= ctypes.sizeof(SharedRegionV1)
        if not exists and not create:
            raise FileNotFoundError(path)
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._thread_lock = _file_thread_lock(path)
        self._fd = os.open(path, flags, 0o666)
        try:
            fcntl.lockf(self._fd, fcntl.LOCK_EX)
            try:
                size = os.fstat(self._fd).st_size
                empty = size == 0
                undersized = size < ctypes.sizeof(SharedRegion)
                struct_type = SharedRegion
                if not create and undersized and \
                        size >= ctypes.sizeof(SharedRegionV1):
                    # reader during a rolling upgrade: a live v1 shim still
                    # owns this file — map the v1 layout instead of going
                    # blind on the container (all read accessors are v1)
                    struct_type = SharedRegionV1
                elif undersized:
                    os.ftruncate(self._fd, ctypes.sizeof(SharedRegion))
                self._mm = mmap.mmap(self._fd, ctypes.sizeof(struct_type))
                self.data = struct_type.from_buffer(self._mm)
                if self.data.magic != VTPU_SHM_MAGIC:
                    if not create:
                        # a reader (monitor) must never initialize a region
                        # the shim is still setting up — report not-ready
                        data = self.data
                        del self.data
                        del data
                        self._mm.close()
                        raise RegionNotReady(path)
                    ctypes.memset(ctypes.addressof(self.data), 0,
                                  ctypes.sizeof(SharedRegion))
                    self.data.magic = VTPU_SHM_MAGIC
                    self.data.version = VTPU_SHM_VERSION
                    self.data.recent_kernel = 1
                    self.data.init_done = 1
                elif undersized and struct_type is SharedRegion and \
                        not empty:
                    # zero-extended live v1 region: appended fields arrive
                    # zeroed (bucket initializes lazily); stamp the version
                    self.data.version = VTPU_SHM_VERSION
            finally:
                fcntl.lockf(self._fd, fcntl.LOCK_UN)
        except BaseException:
            os.close(self._fd)
            raise

    def close(self) -> None:
        data = self.data
        del self.data
        del data
        self._mm.close()
        os.close(self._fd)

    @contextlib.contextmanager
    def locked(self):
        """Thread lock (vs this process) + file lock (vs Python) + native
        sem lock (vs C) for mutations.

        POSIX record locks are per-process: without the thread lock, two
        threads of one process would both "acquire" instantly, and the
        first LOCK_UN would drop the process's lock while the second is
        still in its critical section — no exclusion against other
        processes. The thread lock spans the whole scope so the fcntl
        acquire/release stays balanced (one thread in at a time), and when
        the native primitives are unavailable it is still the in-process
        guard.
        """
        native = _native_shm()
        addr = ctypes.addressof(self.data)
        with self._thread_lock:
            fcntl.lockf(self._fd, fcntl.LOCK_EX)
            try:
                if native is not None:
                    native.vtpu_shm_lock(addr)
                try:
                    yield
                finally:
                    if native is not None:
                        native.vtpu_shm_unlock(addr)
            finally:
                fcntl.lockf(self._fd, fcntl.LOCK_UN)

    # ---- convenience accessors (monitor + limiter side) ----

    def active_procs(self):
        return [p for p in self.data.procs if p.status == 1]

    def device_used(self, dev: int) -> int:
        return sum(p.used[dev].total for p in self.active_procs())

    def attach(self, pid: int) -> int:
        """Register this pid in a free slot (shim-compatible, race-safe)."""
        with self.locked():
            free = -1
            for i, p in enumerate(self.data.procs):
                if p.status == 1 and p.pid == pid:
                    return i
                if free < 0 and p.status == 0:
                    free = i
            if free < 0:
                raise RuntimeError("no free proc slot")
            slot = self.data.procs[free]
            ctypes.memset(ctypes.addressof(slot), 0, ctypes.sizeof(slot))
            slot.pid = pid
            slot.status = 1
            return free

    def detach(self, pid: int) -> None:
        with self.locked():
            for p in self.data.procs:
                if p.status == 1 and p.pid == pid:
                    ctypes.memset(ctypes.addressof(p), 0, ctypes.sizeof(p))

    def set_limits(self, limits_bytes: list[int],
                   core_percent: int | None = None) -> None:
        for i, lim in enumerate(limits_bytes[:MAX_DEVICES]):
            self.data.limit[i] = lim
        self.data.num_devices = max(self.data.num_devices, len(limits_bytes))
        if core_percent is not None:
            for i in range(MAX_DEVICES):
                self.data.sm_limit[i] = core_percent


def abi_layout() -> dict[str, tuple[int, int]]:
    """(offset, size) per field, for the vtpu_abi_dump cross-check."""
    out = {
        "sizeof_region": (ctypes.sizeof(SharedRegion), 0),
        "sizeof_proc_slot": (ctypes.sizeof(ProcSlot), 0),
        "sizeof_device_memory": (ctypes.sizeof(DeviceMemory), 0),
    }
    for name, _ in SharedRegion._fields_:
        field = getattr(SharedRegion, name)
        out[name] = (field.offset, field.size)
    return out
