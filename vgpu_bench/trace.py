"""The device trace of a ``--trace 1`` run.

Each tenant records its own ``torch.profiler`` trace (device activity
only, kept in memory) over its window and keeps a summary: its device
intervals clipped to the window, and time and count by operation name.
The supervisor merges the tenants' summaries on the wall clock, which the
profiler's timestamps share (nanoseconds since the epoch): the union of
the intervals is the card's busy time, each instant of it is split evenly
among the tenants whose operations cover it (contexts time-slice, so a
preempted kernel's interval can span a neighbour's), and the gaps between
are the card's idle time, each named by what the tenants' hosts were
doing then. An operation's time is its share of the busy time so split:
under time slicing a kernel's own interval also holds the neighbours'
slices it waited through.
"""

from __future__ import annotations

import numpy as np

#: entries of each list of the result's ``breakdown``
BREAKDOWN_ENTRIES = 10


def start(device):
    """A profiler of ``device``'s activity (on the CPU, a rehearsal's, its
    operators), started."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def summarize(prof, device, t0_ns: int, t1_ns: int) -> dict:
    """Stop ``prof``; ``device``'s operations between ``t0_ns`` and
    ``t1_ns``: ``intervals`` [n, 3] (int64 ns, clipped, and the index of
    the operation's name in ``names``), and ``device_events``, all that the
    trace holds."""
    import torch
    prof.stop()
    kind = getattr(torch._C._autograd.DeviceType, device.type.upper())
    spans, names, total = [], {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != kind:
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        total += 1
        if t <= t0_ns or s >= t1_ns:
            continue
        spans.append((max(s, t0_ns), min(t, t1_ns),
                      names.setdefault(e.name(), len(names))))
    return {"intervals": np.asarray(spans, dtype=np.int64).reshape(-1, 3),
            "names": list(names), "device_events": total}


def _host_state(calls: np.ndarray, t: int) -> str:
    """What a tenant's host was doing at ``t``: issuing a call (its launch
    hooks, the shim's sleeps among them), waiting for it, or neither."""
    k = int(np.searchsorted(calls[:, 0], t, side="right")) - 1
    if k < 0:
        return "idle"
    issue, ret, done = calls[k]
    return "enqueue" if t < ret else "sync" if t < done else "loop"


def merge(tenants: list[dict], t0_ns: int, t1_ns: int) -> dict:
    """The card's view of the window [t0_ns, t1_ns] from every tenant's
    summary (``intervals``, ``names``) and calls ([n, 3] ns: issue,
    return, done). ``ops`` is {name: [launches, seconds]}, the seconds
    its share of the busy time."""
    n = len(tenants)
    bounds, deltas = [], []
    for i, t in enumerate(tenants):
        iv = t["intervals"]
        bounds += [iv[:, 0], iv[:, 1]]
        d = np.zeros((2 * len(iv), n), dtype=np.int32)
        d[:len(iv), i] = 1
        d[len(iv):, i] = -1
        deltas.append(d)
    points = np.concatenate(bounds + [np.array([t0_ns, t1_ns],
                                                dtype=np.int64)])
    delta = np.concatenate(deltas + [np.zeros((2, n), dtype=np.int32)])
    order = np.argsort(points, kind="stable")
    points, active = points[order], np.cumsum(delta[order], axis=0) > 0
    # segment k runs from points[k] to points[k + 1] with active[k]
    length = np.diff(points).astype(np.float64) / 1e9
    active = active[:-1]
    count = active.sum(axis=1)
    busy = count > 0
    share = np.where(busy, 1.0 / np.maximum(count, 1), 0.0)
    split = active * (share * length)[:, None]
    attributed = split.sum(axis=0)
    # a tenant's share of the busy time up to each point; its operations
    # do not overlap one another (one stream), so an interval's share is
    # the difference at its ends
    upto = np.vstack([np.zeros((1, n)), np.cumsum(split, axis=0)])
    ops = {}
    for i, t in enumerate(tenants):
        iv = t["intervals"]
        at = upto[np.searchsorted(points, iv[:, 1]), i] \
            - upto[np.searchsorted(points, iv[:, 0]), i]
        k = len(t["names"])
        launches = np.bincount(iv[:, 2], minlength=k)
        seconds = np.bincount(iv[:, 2], weights=at, minlength=k)
        for name, c, secs in zip(t["names"], launches, seconds):
            entry = ops.setdefault(name, [0, 0.0])
            entry[0] += int(c)
            entry[1] += float(secs)
    gaps = []
    for k in np.flatnonzero(~busy & (length > 0)):
        if gaps and gaps[-1][1] == points[k]:
            gaps[-1][1] = points[k + 1]
        else:
            gaps.append([points[k], points[k + 1]])
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:BREAKDOWN_ENTRIES]:
        mid = (int(g0) + int(g1)) // 2
        states = sorted(_host_state(t["calls"], mid) for t in tenants)
        label = ", ".join(f"{s} {states.count(s)}"
                          for s in dict.fromkeys(states))
        named.append([f"hosts: {label}", (int(g1) - int(g0)) / 1e9])
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:BREAKDOWN_ENTRIES]
    return {"busy_s": float(length[busy].sum()),
            "window_s": (t1_ns - t0_ns) / 1e9,
            "attributed_s": [float(a) for a in attributed],
            "ops": ops,
            "breakdown": {"device_ops": [[k, v[1]] for k, v in top],
                          "idle_gaps": named}}
