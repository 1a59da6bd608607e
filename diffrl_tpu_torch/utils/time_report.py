"""Named wall-clock timers (port of diffrl_tpu/utils/time_report.py), and
the program's spans and counters on the device trace's clock.

``TimeReport`` keeps the reference's named timers, which ``train()``
reports.

``span(name)`` marks one layer boundary of the program (``traced(name)``
is its decorator, ``epoch_span(name)`` the decorator of a trainer's root
span) and ``count(name)`` one event inside the innermost open span. Both
record only while a ``torch.profiler`` is active
(``torch.autograd.profiler._is_profiler_enabled``: the harness's profiled
epoch, ``chip_smoke.py``'s profile, ``utils.profiling.trace()``); otherwise
``span()`` returns one shared no-op and ``count()`` returns at once. A
recorded span holds:

- its name, its start and its end in ``time.time_ns()``, the clock of the
  profiler's events (``start_ns()`` is Unix time);
- its parent's id and its thread;
- its epoch: the trainer's ``iter_count``, given to a root span (the
  trainers' ``*.epoch`` and ``*.stats``) and inherited by its children;
- ``counts``: the events counted while it was the innermost open span of
  its thread, and the launches of K1, K2 and K3 between its start and its
  end (``k1.launches``, ``k2.launches`` and ``k3.launches``, read from the
  kernel wrappers' ``launches`` attributes in ``sim/substep_kernels``:
  ``substep_forward``, ``substep_vjp`` and ``mass_matrix_vjp``, which count
  CUDA launches and not the CPU's plain path).

Stacks are per thread. A span opened on a thread with no open span takes
as parent the latest-started span open on any thread: the one open where
the work was handed over (autograd runs CUDA backward on its own device
thread while the caller waits in ``backward()``). Finished spans stay in a
bounded buffer until read (``spans()``, ``clear()``).

Host-device synchronizations (``host.syncs``): on CUDA a root span sets
``torch.cuda.set_sync_debug_mode("warn")`` on entry and restores the mode
on exit; each of torch's warnings is counted against the innermost open
span of the thread that raised it, and not printed. Syncs inside autograd's
own C++ nodes reach Python when ``backward()`` returns, on the calling
thread.
"""

from __future__ import annotations

import collections
import functools
import itertools
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: finished spans kept until read; the oldest go first
MAX_SPANS = 1 << 17
#: torch's warning for a synchronizing CUDA operation under sync debug mode
SYNC_WARNING = "called a synchronizing CUDA operation"
_KERNELS = __name__.rsplit(".", 2)[0] + ".sim.substep_kernels"


class Timer:
    def __init__(self, name):
        self.name = name
        self.start_time = None
        self.time_total = 0.0

    def on(self):
        assert self.start_time is None, f"timer {self.name} already on"
        self.start_time = time.time()

    def off(self):
        assert self.start_time is not None, f"timer {self.name} not on"
        self.time_total += time.time() - self.start_time
        self.start_time = None

    def report(self):
        print(f"time report [{self.name}]: {self.time_total:.2f} seconds")

    def clear(self):
        self.start_time = None
        self.time_total = 0.0


class TimeReport:
    def __init__(self):
        self.timers = {}

    def add_timer(self, name):
        assert name not in self.timers
        self.timers[name] = Timer(name)

    def start_timer(self, name):
        self.timers[name].on()

    def end_timer(self, name):
        self.timers[name].off()

    def add_time(self, name, seconds):
        """Accumulate an externally-measured duration (used by pipelined
        epoch loops where start/stop pairs around the async dispatch would
        only time the dispatch, not the epoch)."""
        self.timers[name].time_total += seconds

    def report(self, name=None):
        if name is not None:
            self.timers[name].report()
        else:
            print("------------Time Report------------")
            for t in self.timers.values():
                t.report()
            print("-----------------------------------")

    def clear_timer(self, name=None):
        if name is not None:
            self.timers[name].clear()
        else:
            for t in self.timers.values():
                t.clear()

    def pop_timer(self, name=None):
        if name is not None:
            self.timers[name].report()
            del self.timers[name]
        else:
            self.report()
            self.timers = {}


# ---------------------------------------------------------------- recorder


class Span:
    """One recorded span (module docstring)."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "thread",
                 "epoch", "counts")

    def __init__(self, name, parent, thread, epoch):
        self.id = next(_ids)
        self.name = name
        self.parent = parent.id if parent is not None else None
        self.thread = thread
        self.epoch = epoch if epoch is not None else (
            parent.epoch if parent is not None else None)
        self.counts: Dict[str, int] = {}
        self.start_ns = self.end_ns = 0


_ids = itertools.count(1)
_done: collections.deque = collections.deque(maxlen=MAX_SPANS)
_stacks: Dict[int, List[Span]] = {}     # thread ident -> its open spans
_counting = threading.Lock()            # a span's counts, from any thread


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _launches():
    k = sys.modules.get(_KERNELS)
    if k is None:
        return 0, 0, 0
    return (k.substep_forward.launches, k.substep_vjp.launches,
            k.mass_matrix_vjp.launches)


def _latest_open() -> Optional[Span]:
    """The latest-started span open on any thread."""
    tops = [s[-1] for s in list(_stacks.values()) if s]
    return max(tops, key=lambda s: s.start_ns) if tops else None


def _innermost() -> Optional[Span]:
    stack = _stacks.get(threading.get_ident())
    return stack[-1] if stack else _latest_open()


class _Recording:
    __slots__ = ("span", "stack", "k0", "syncs")

    def __init__(self, name, epoch):
        ident = threading.get_ident()
        stack = _stacks.setdefault(ident, [])
        parent = stack[-1] if stack else _latest_open()
        self.span = Span(name, parent, ident, epoch)
        self.stack = stack
        self.syncs = _SyncCounter() if epoch is not None else None

    def __enter__(self):
        if self.syncs is not None:
            self.syncs.on()
        self.k0 = _launches()
        self.stack.append(self.span)
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        s = self.span
        s.end_ns = time.time_ns()
        for i, n in enumerate(_launches()):
            s.counts[f"k{i + 1}.launches"] = n - self.k0[i]
        self.stack.pop()
        if self.syncs is not None:
            self.syncs.off()
        _done.append(s)
        return False


class _SyncCounter:
    """torch's sync detector in "warn" mode over one root span, its
    warnings counted as ``host.syncs`` and not shown; the previous mode,
    filters and ``showwarning`` come back on exit."""

    __slots__ = ("mode", "saved", "shown")

    def on(self):
        self.mode = None
        if not torch.cuda.is_initialized():
            return
        self.saved = warnings.catch_warnings()
        self.saved.__enter__()
        self.shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = self._show
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_WARNING in str(message):
            count("host.syncs")
        else:
            self.shown(message, category, filename, lineno, file, line)

    def off(self):
        if self.mode is None:
            return
        torch.cuda.set_sync_debug_mode(self.mode)
        self.saved.__exit__(None, None, None)


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    is active (the shared no-op otherwise)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, None)


def traced(name: str):
    """Decorator: the function's calls are spans ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Recording(name, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def epoch_span(name: str):
    """Decorator of a trainer's method: its calls are root spans ``name``
    at the trainer's ``iter_count``, with the sync detector on."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(self, *args, **kwargs)
            with _Recording(name, self.iter_count):
                return fn(self, *args, **kwargs)
        return inner
    return wrap


def count(name: str) -> None:
    """Count one event ``name`` against the innermost open span while a
    profiler is active."""
    if not _profiler._is_profiler_enabled:
        return
    s = _innermost()
    if s is not None:
        with _counting:
            s.counts[name] = s.counts.get(name, 0) + 1


def spans() -> List[Span]:
    """The finished spans in the buffer, in the order they ended."""
    return list(_done)


def clear() -> None:
    _done.clear()
