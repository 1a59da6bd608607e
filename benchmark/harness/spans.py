"""The port's own spans over the profiled epoch, and the benchmark's
arithmetic on them.

The port records spans and counters only while a profiler is active
(``diffrl_tpu_torch/utils/time_report.py``), so during ``--trace 1``'s
profiled epoch; their stamps are ``time.time_ns()``, the clock of the
profiler's events. What is taken from the port is the raw record of each
span: its name, start, end, id, parent's id, thread, epoch and counts. Which
spans belong to the epoch, self times, and which span each idle gap of
the card falls in are worked out here, so that no change to the program
can move them. A port without the recorder gives no spans, and the
metrics that read them are left out.
"""

from __future__ import annotations

import bisect
import collections
import importlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

RECORDER = "diffrl_tpu_torch.utils.time_report"
#: the port's checkpoint write: its host reads are not the epoch's work
SAVE = "trainer.save"


@dataclass(frozen=True)
class Rec:
    id: int
    name: str
    a: float                     # start, seconds (Unix time)
    b: float                     # end
    parent: Optional[int]
    thread: int
    counts: Tuple[Tuple[str, int], ...]
    epoch: Optional[int] = None  # the trainer's iter_count at the root

    def count(self, key: str) -> int:
        return dict(self.counts).get(key, 0)


def raw_spans() -> Optional[List[Rec]]:
    """Every span the port's recorder holds, or None where the port has
    no recorder."""
    try:
        module = importlib.import_module(RECORDER)
    except ImportError:
        return None
    read = getattr(module, "spans", None)
    if read is None:
        return None
    return [Rec(int(s.id), str(s.name), s.start_ns * 1e-9, s.end_ns * 1e-9,
                None if s.parent is None else int(s.parent), int(s.thread),
                tuple(sorted((str(k), int(v)) for k, v in s.counts.items())),
                None if s.epoch is None else int(s.epoch))
            for s in read()]


def epoch_spans(trace) -> Optional[List[Rec]]:
    """The spans of the profiled epoch (``select_epoch``) among those the
    port's recorder holds. None where the port records none."""
    return select_epoch(trace, raw_spans())


def select_epoch(trace, recs: Optional[List[Rec]]) -> Optional[List[Rec]]:
    """The spans within the epoch's roots: the roots (spans without a
    parent) that overlap the trace's device operations, and every root of
    the same epoch (a trainer's statistics may start after the card has
    finished the epoch's work). None where there are none."""
    if not recs or trace is None or not trace.device:
        return None
    lo = trace.device[0][0]
    hi = max(b for _, b, _ in trace.device)
    roots = [r for r in recs if r.parent is None]
    seen = [r for r in roots if r.a < hi and r.b > lo]
    epochs = {r.epoch for r in seen} - {None}
    roots = seen + [r for r in roots if r not in seen and r.epoch in epochs]
    if not roots:
        return None
    a = min(r.a for r in roots)
    b = max(r.b for r in roots)
    return [r for r in recs if r.a >= a and r.b <= b]


def total_ms(recs: List[Rec], name: str) -> Optional[float]:
    """Milliseconds in the spans ``name``; None where there are none."""
    hits = [r.b - r.a for r in recs if r.name == name]
    return 1e3 * sum(hits) if hits else None


def self_ms(recs: List[Rec], name: str) -> Optional[float]:
    """Milliseconds in the spans ``name`` less their children's."""
    ids = {r.id for r in recs if r.name == name}
    if not ids:
        return None
    own = sum(r.b - r.a for r in recs if r.id in ids)
    children = sum(r.b - r.a for r in recs if r.parent in ids)
    return 1e3 * (own - children)


def idle_gaps(trace, recs: List[Rec]) -> List[Tuple[float, float]]:
    """The stretches of the epoch in which the card ran nothing: from the
    first root's start to the last root's end, or the device's first and
    last operations where they lie outside, less the union of the device
    operations."""
    dev = trace.device
    start = min([r.a for r in recs] + [dev[0][0]])
    end = max([r.b for r in recs] + [b for _, b, _ in dev])
    gaps, cur = [], start
    for a, b, _ in dev:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if end > cur:
        gaps.append((cur, end))
    return gaps


class Innermost:
    """The innermost span open at a time, on any thread: of the spans
    open then, the one that started last."""

    def __init__(self, recs: List[Rec]):
        points = sorted({r.a for r in recs} | {r.b for r in recs})
        starts = collections.defaultdict(list)
        ends = collections.defaultdict(list)
        for r in recs:
            starts[r.a].append(r)
            ends[r.b].append(r)
        open_: Dict[int, Rec] = {}
        self.points = points
        self.owner: List[Optional[Rec]] = []
        for t in points:
            for r in ends[t]:
                open_.pop(r.id, None)
            for r in starts[t]:
                if r.b > t:
                    open_[r.id] = r
            self.owner.append(max(open_.values(), key=lambda r: (r.a, r.id))
                              if open_ else None)

    def at(self, t: float) -> Optional[Rec]:
        i = bisect.bisect_right(self.points, t) - 1
        return self.owner[i] if i >= 0 else None


def idle_by_span(trace, recs: List[Rec]) -> Dict[Optional[str], float]:
    """Seconds of the card's idle time per innermost span open at each
    gap's midpoint (None: no span open there)."""
    where = Innermost(recs)
    out: Dict[Optional[str], float] = collections.defaultdict(float)
    for a, b in idle_gaps(trace, recs):
        r = where.at(0.5 * (a + b))
        out[None if r is None else r.name] += b - a
    return dict(out)


def idle_pct(trace, recs: List[Rec],
             within: Callable[[Optional[str]], bool]) -> Optional[float]:
    """Percent of the card's idle time whose innermost span at the gap's
    midpoint has a name for which ``within`` holds (None: no span open);
    None where the card was never idle."""
    idle = idle_by_span(trace, recs)
    total = sum(idle.values())
    if total <= 0.0:
        return None
    return 100.0 * sum(s for name, s in idle.items() if within(name)) / total


def syncs(recs: List[Rec]) -> int:
    """The ``host.syncs`` counted in the spans, less those counted in a
    ``SAVE`` span or under one: whether an epoch writes a checkpoint
    depends on the wall clock, and each write reads every tensor back."""
    by_id = {r.id: r for r in recs}

    def saving(r: Optional[Rec]) -> bool:
        while r is not None:
            if r.name == SAVE:
                return True
            r = by_id.get(r.parent)
        return False

    return sum(r.count("host.syncs") for r in recs if not saving(r))
