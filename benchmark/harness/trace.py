"""The device trace of one profiled epoch, read in memory: every kernel,
copy and fill that ran on the card, with its start and length, and the
runtime calls that the host made meanwhile where the profiler records
them. The busy time is the union of the device intervals (the arithmetic
of the port's ``utils/profiling.device_busy_share``)."""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import List, Tuple

import torch


@dataclass
class Trace:
    window_s: float                       # host clock over the epoch
    device: List[Tuple[float, float, str]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        busy, cur_a, cur_b = 0.0, None, None
        for a, b, _ in self.device:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        return busy

    def kernels(self, substring: str) -> List[float]:
        """The lengths of the device operations whose name holds
        ``substring``."""
        return [b - a for a, b, n in self.device if substring in n]

    def top_ops(self, n=10):
        total = collections.Counter()
        for a, b, name in self.device:
            total[name] += b - a
        return [[name, s] for name, s in total.most_common(n)]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between device operations, each named by
        the host's runtime call in progress at the gap's middle (or the
        device operation that ends it where none is recorded)."""
        gaps, end, nxt = [], None, None
        for a, b, name in self.device:
            if end is not None and a > end:
                gaps.append((a - end, end, a, name))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        host = sorted(self.host)
        out = []
        for length, a, b, following in gaps[:n]:
            mid = 0.5 * (a + b)
            calls = [h for h in host if h[0] <= mid <= h[1]]
            label = (f"host in {calls[-1][2]}" if calls
                     else f"host, before {following}")
            out.append([label, length])
        return out


def profile_epoch(fn, cuda: bool = True) -> Trace:
    """Runs ``fn`` (one epoch) under the profiler with CUDA activity alone
    and reads its events in memory. Without ``cuda`` (the CPU tests' tiny
    runs) the CPU's operators stand in for the device's, so that the
    reading is exercised; such a trace measures nothing of the card."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    sync()
    with profile(activities=[activity]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t
    tr = Trace(window_s=window)
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-9
        span = (a, a + e.duration_ns() * 1e-9, e.name())
        if not cuda or e.device_type() == torch.autograd.DeviceType.CUDA:
            tr.device.append(span)
        else:
            tr.host.append(span)
    tr.device.sort()
    if not tr.device:
        raise RuntimeError("the profiler recorded no device operation")
    return tr
