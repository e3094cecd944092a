"""The enforcement shim's own counters and bucket-wait spans, read from
inside the process it is loaded in (``libvtpu_cuda.so`` in
``LD_PRELOAD``): the interface an operator uses from inside a pod.

:func:`counters` returns ordinal ``dev``'s counters, each only growing
(take the difference of two reads for a window):

- ``launches``: calls through a launch hook, capped, uncapped or while a
  stream captures; a graph's launch is one;
- ``charged_us``: the cost charged to the duty bucket, launch by launch
  (0 without a core limit);
- ``granted_us``: the cost the bucket granted, in batches of at least
  1 ms: below ``charged_us`` by what waits for the next batch;
- ``waits``, ``slept_ns``: the bucket's calls that slept (for tokens, or
  in the monitor's priority block) and the time they slept;
- ``hook_ns``: the hooks' own time around each launch, less the sleeps;
- ``driver_ns``: the time inside the driver's launch calls;
- ``timed``, ``timed_us``: the event-timed launches read into the cost
  estimate, and the device time they read.

:func:`spans` returns the bucket's waits: one row a call that slept,
stamped in ``CLOCK_REALTIME`` ns (the clock of :func:`time.time_ns` and of
the profiler's device timestamps), numbered in the order they end; the
shim keeps the last :data:`SPAN_RING`.

Both return ``None`` in a process without the shim, or where it failed
open (the kill switch, no region): then nothing is enforced or counted.
"""

from __future__ import annotations

import ctypes

#: the counters, in the order of the shim's struct (version 1)
FIELDS = ("launches", "charged_us", "granted_us", "waits", "slept_ns",
          "hook_ns", "driver_ns", "timed", "timed_us")
#: the columns of :func:`spans`' rows
SPAN_COLUMNS = ("start_ns", "end_ns", "cost_us", "dev", "kinds")
#: bits of a span's ``kinds``: what it slept for
WAIT_BUCKET, WAIT_BLOCK = 1, 2
#: the spans the shim keeps
SPAN_RING = 16384


class _Counters(ctypes.Structure):
    _fields_ = [("size", ctypes.c_uint32), ("version", ctypes.c_uint32),
                *((name, ctypes.c_uint64) for name in FIELDS)]


class _Span(ctypes.Structure):
    _fields_ = [("start_ns", ctypes.c_uint64), ("end_ns", ctypes.c_uint64),
                ("cost_us", ctypes.c_uint64), ("dev", ctypes.c_int32),
                ("kinds", ctypes.c_uint32)]


def _shim(name: str, restype, *argtypes):
    """The shim's ``name`` among this process's symbols, or None."""
    try:
        fn = getattr(ctypes.CDLL(None), name)
    except AttributeError:
        return None
    fn.restype, fn.argtypes = restype, argtypes
    return fn


def counters(dev: int = 0) -> dict[str, int] | None:
    """Ordinal ``dev``'s counters ({name: value}), or None (no shim, or
    it failed open). A shim with a shorter struct fills, and this returns,
    only the fields it has."""
    fn = _shim("vtpu_cuda_counters", ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(_Counters))
    out = _Counters(size=ctypes.sizeof(_Counters))
    if fn is None or fn(dev, ctypes.byref(out)) != 0:
        return None
    filled = (out.size - _Counters.launches.offset) // 8
    return {name: getattr(out, name) for name in FIELDS[:filled]}


def spans(since: int = 0) -> tuple[list[tuple[int, ...]], int, int] | None:
    """(rows, next, lost) of the bucket's waits numbered from ``since``
    on: rows of :data:`SPAN_COLUMNS`, oldest first; ``next`` the number to
    pass for the spans after these (a ``since`` past the last span reads
    none, and ``next`` is the number of the next to come); ``lost`` how
    many from ``since`` on the ring had overwritten. None without the
    shim."""
    fn = _shim("vtpu_cuda_spans", ctypes.c_int64, ctypes.c_uint64,
               ctypes.POINTER(_Span), ctypes.c_uint64,
               ctypes.POINTER(ctypes.c_uint64))
    if fn is None:
        return None
    buf = (_Span * SPAN_RING)()
    nxt = ctypes.c_uint64()
    rows, seq, lost = [], since, None
    while True:
        n = fn(seq, buf, SPAN_RING, ctypes.byref(nxt))
        if n < 0:
            return None
        if lost is None:
            lost = max(nxt.value - n - since, 0)
        rows += [tuple(getattr(s, c) for c in SPAN_COLUMNS) for s in buf[:n]]
        seq = nxt.value
        if n < SPAN_RING:
            break
    return rows, seq, lost
