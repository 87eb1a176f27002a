"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer readers take.

The window is the benchmark's own ``nnpbench.window`` annotation; device
time is every kernel, copy and set interval of the card inside it.  The
trace is written into the run's temporary directory, read back once and
deleted.
"""

import json
import os
from collections import defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "nnpbench.window"


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def annotate(name):
    return torch.profiler.record_function(name)


def _union(starts, ends):
    """Sorted disjoint intervals covering the given ones."""
    if len(starts) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


class Trace:
    """Device intervals, host operations and the benchmark's own spans of the
    traced window, in seconds of the trace's clock."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' annotations, not one")
        self.t0 = float(win[0]["ts"]) * 1e-6
        self.t1 = self.t0 + float(win[0]["dur"]) * 1e-6
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.names = [e["name"] for e in dev]
        self.cats = [e["cat"] for e in dev]
        ts = np.array([float(e["ts"]) for e in dev]) * 1e-6
        te = ts + np.array([float(e.get("dur", 0.0)) for e in dev]) * 1e-6
        self.start, self.end = np.clip(ts, self.t0, self.t1), np.clip(te, self.t0, self.t1)
        self.union = _union(self.start, self.end)
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
                and e.get("name") != WINDOW]
        self.host_names = [e["name"] for e in host]
        self.host_start = np.array([float(e["ts"]) for e in host]) * 1e-6
        self.host_end = self.host_start + np.array([float(e.get("dur", 0.0)) for e in host]) * 1e-6

    @property
    def window_s(self):
        return self.t1 - self.t0

    @property
    def busy_s(self):
        s, e = self.union
        return float((e - s).sum())

    def by_name(self, cats=DEVICE_CATS):
        """{name: [device seconds, launches]} inside the window."""
        agg = defaultdict(lambda: [0.0, 0])
        for name, cat, s, e in zip(self.names, self.cats, self.start, self.end):
            if cat in cats:
                row = agg[name]
                row[0] += float(e - s)
                row[1] += 1
        return dict(agg)

    def kernel_launches(self):
        return sum(1 for c in self.cats if c == "kernel")

    def idle_gaps(self, top=10, labelled=200):
        """The idle time between device intervals, by what the host was doing
        when each gap began (its innermost operation or span): [[label,
        seconds]], the labels of the ``labelled`` longest gaps, largest
        total first."""
        s, e = self.union
        gs = np.concatenate([[self.t0], e])
        ge = np.concatenate([s, [self.t1]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        order = np.argsort(gs - ge, kind="stable")[:labelled]
        totals = defaultdict(float)
        for k in order:
            at = gs[k]
            inside = np.flatnonzero((self.host_start <= at) & (self.host_end > at))
            if len(inside):
                label = self.host_names[inside[np.argmin(self.host_end[inside] - self.host_start[inside])]]
            else:
                label = "no host operation"
            totals[label] += float(ge[k] - gs[k])
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top=10):
        rows = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:top]
        return [[name, secs] for name, (secs, _) in rows]


def read(prof, tmpdir):
    """Export ``prof``'s trace into ``tmpdir``, reduce it and delete the file."""
    path = os.path.join(tmpdir, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
