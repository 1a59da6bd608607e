"""Device profiling helpers (port of diffrl_tpu/utils/profiling.py).

``trace()`` records a ``torch.profiler`` trace (CPU and, on a CUDA device,
CUDA activity through CUPTI) around a block of work and writes it as a
Chrome trace, with the program's spans (``utils/time_report.py``) as one
more track, "diffrl_tpu_torch spans"; ``summarize_trace()`` aggregates
duration and count per op name from the written trace, as the JAX
package's does from its XLA trace.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import shutil
import time
from typing import Optional, Sequence

import torch

from .. import default_device
from . import time_report

#: Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the process name of the track that holds the program's spans
SPAN_TRACK = "diffrl_tpu_torch spans"
#: how much of a trace's head and tail is read for its layout
_PEEK = 1 << 20
_BASE = re.compile(r'"baseTimeNanoseconds"\s*:\s*(\d+)')


def _device_events(events):
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace", device=None):
    """Record a trace around a block of work into
    ``<log_dir>/<time>.trace.json``. ``device`` (CUDA unless named) sets the
    activities: CPU and CUDA on a CUDA device, CPU alone for
    ``device="cpu"``. On CUDA the block's work is synchronized before the
    trace ends, and a trace without device events raises. The spans that
    the program recorded meanwhile are added as the track ``SPAN_TRACK``,
    one row per thread, each with its counts in ``args``."""
    dev = default_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{time.time_ns()}.trace.json")
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in time_report.spans() if s.start_ns >= t0])
    if dev.type == "cuda":
        with open(path) as f:    # a substring test: the trace may be large
            text = f.read()
        if not any(f'"cat": "{c}"' in text for c in DEVICE_CATEGORIES):
            raise RuntimeError(f"{path}: the profiler recorded no device "
                               "event (CUPTI tracing unavailable?)")


def _add_spans(path, spans):
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    at the head of its ``traceEvents``, on the trace's own time base; the
    rest of the file is copied as it is."""
    if not spans:
        return
    with open(path) as f:
        head = f.read(_PEEK)
    found = re.search(r'"traceEvents"\s*:\s*\[', head)
    if found is None:
        raise RuntimeError(f"{path}: no traceEvents to add the spans to")
    base = _base_ns(path, head)
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK,
               "tid": 0, "args": {"name": SPAN_TRACK}}]
    events += [{"ph": "X", "cat": "span", "name": s.name, "pid": SPAN_TRACK,
                "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": dict(s.counts, id=s.id, parent=s.parent,
                             epoch=s.epoch)} for s in spans]
    text = ",\n".join(json.dumps(e) for e in events)
    rest = head[found.end():].lstrip()
    if not rest.startswith("]"):
        text += ","
    tmp = path + ".tmp"
    with open(path) as src, open(tmp, "w") as out:
        out.write(src.read(found.end()))
        out.write("\n" + text + "\n")
        shutil.copyfileobj(src, out)
    os.replace(tmp, path)


def _base_ns(path, head) -> int:
    """The trace's ``baseTimeNanoseconds``, which Kineto writes before
    ``traceEvents`` or in the trailer after them (the events' ``ts`` are
    microseconds after it); 0 where the trace names none (its ``ts`` are
    then Unix microseconds)."""
    base = _BASE.search(head)
    if base is None:
        with open(path, "rb") as f:
            f.seek(max(0, os.path.getsize(path) - _PEEK))
            base = _BASE.search(f.read().decode("utf-8", "replace"))
    return int(base.group(1)) if base else 0


def load_trace(log_dir: str):
    """The events of the newest trace under ``log_dir``."""
    paths = glob.glob(os.path.join(log_dir, "*.trace.json"))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    newest = max(paths, key=lambda p: int(os.path.basename(p).split(".")[0]))
    with open(newest) as f:
        return json.load(f).get("traceEvents", [])


def summarize(events, top: Optional[int] = 25,
              categories: Optional[Sequence[str]] = None):
    """(milliseconds, count, name) per op name of the complete events of a
    trace, the longest first (the ``top`` of them; all for None);
    ``categories`` keeps the events of those trace categories only
    (DEVICE_CATEGORIES: the device's work)."""
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e and (
                categories is None or e.get("cat") in categories):
            name = e.get("name", "")
            dur[name] += e["dur"]
            cnt[name] += 1
    return [(d / 1000.0, cnt[n], n) for n, d in dur.most_common(top)]


def summarize_trace(log_dir: str, top: int = 25,
                    categories: Optional[Sequence[str]] = None):
    """Aggregate and print (milliseconds, count, name) per op name of the
    newest trace under ``log_dir`` (``summarize``)."""
    rows = summarize(load_trace(log_dir), top, categories)
    for ms, c, n in rows:
        print(f"{ms:10.1f} ms  x{c:<6} {n[:100]}")
    return rows


def device_busy_share(events) -> float:
    """The share of a trace's window (its events', from ``load_trace``:
    the first event's start to the last event's end, host events
    included) in which the device ran at least one kernel, copy or fill
    (the union of their intervals)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in _device_events(events))
    if not dev:
        return 0.0
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, cur_a, cur_b = 0.0, dev[0][0], dev[0][1]
    for a, b in dev[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy / (end - start)
