"""One ``torch.profiler`` window over whole requests, reduced to what the
per-layer metrics read: the union of device activity, the device time of
each kernel name, and the idle gaps named by the host span open at the
time. The trace goes to ``TMPDIR`` and is deleted once read."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"


class Trace:
    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the profiler's trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.device = [(max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1),
                        e.get("name", "?")) for e in dev]
        self.device = [d for d in self.device if d[1] > d[0]]
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][10:])
                      for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith("perfbench.") and e["name"] != WINDOW]
        self.host_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
                         for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        merged = []
        for a, b, _ in sorted(self.device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any of ``patterns``."""
        return sum(b - a for a, b, n in self.device if any(p in n for p in patterns)) * 1e-6

    def device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for a, b, name in self.device:
            by[name[:200]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches with nothing on the device, each named
        by the innermost host span around its middle, or else by the
        outermost host operation running then (``host <op>``)."""
        edges = [self.t0] + [x for iv in self.busy_intervals() for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            around = [s for s in self.spans if s[0] <= mid <= s[1]]
            if around:
                name = min(around, key=lambda s: s[1] - s[0])[2]
            else:
                ops = [o for o in self.host_ops if o[0] <= mid <= o[1]]
                name = "host " + max(ops, key=lambda o: o[1] - o[0])[2] if ops else "between spans"
            out.append([name, (b - a) * 1e-6])
        return out


def profile(torch, fn) -> Trace:
    """Run ``fn`` under the profiler inside one window annotation that ends
    with a synchronise, and read the trace back."""
    from torch.profiler import ProfilerActivity, profile as prof, record_function

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        with record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)
