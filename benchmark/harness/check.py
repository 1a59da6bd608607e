"""How ``correct`` is decided: the program's first epochs, which the
set-up drives through the window's own call, against the plain reference's
from the same seed.

A reading of a trainer holds each epoch's losses, the first epoch's
records of every env at every step (the rewards; SHAC's TD(lambda)
targets; PPO's value estimates, advantages and returns), the norm of each
leaf's first gradient as its optimizer took it, and the norm of each
leaf's change over the epochs read. ``compare`` turns two readings into
every number the check can hold against a limit; a cell's limits file
names the ones it does:

- ``<loss>1_gap`` and ``<loss>_gap``: the relative gap of that loss in the
  first epoch, and the largest over the epochs;
- ``<record>1_p999_gap`` (``rew1_p999_gap``, ``target1_p999_gap``, ...):
  over the first epoch's (step, env) records, the 99.9th percentile of
  the gap over the reference's record or its median magnitude, whichever
  is larger (past the few envs whose contacts take the other side of a
  select in float32 and part ways over the rollout: a thousandth of the
  records, where the faults it is to catch alter a fiftieth or more);
- ``grad1_gap.<module>`` and ``dparam_gap``: by the worst leaf (of the
  module, or of all), the gap between the two norms over the reference's
  norm of that leaf or of the median leaf of its module, whichever is
  larger.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's move by round-off alone and are left out."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from .subjects import param_snapshot

EXCLUDE_BELOW = 1e-3     # of the median leaf's first-gradient norm
RECORDS_QUANTILE = 0.999


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def read(subject, epochs: int, keep_state=False) -> Dict:
    """Runs ``epochs`` epochs of ``subject`` and reads them; with
    ``keep_state`` also its envs' joint coordinates after them."""
    theta0 = param_snapshot(subject.modules())
    subject.watch_first_steps()
    losses: List[Dict[str, float]] = []
    for _ in range(epochs):
        subject.epoch()
        losses.append(subject.losses())
    grads = subject.first_grads()
    theta = param_snapshot(subject.modules())
    if keep_state:
        state = subject.tr.env_state.joint_q.detach().double().cpu()
    else:
        state = None
    return {
        "env_q": state,
        "losses": losses,
        "records1": subject.first_records(),
        "grad1": {m: {n: _norm(g) for n, g in leaves.items()}
                  for m, leaves in grads.items()},
        "dparam": {m: {n: _norm(theta[m][n] - theta0[m][n])
                       for n in leaves} for m, leaves in theta.items()},
    }


def _leaf_gaps(prog, ref, keep) -> Dict[str, float]:
    """Per module, the worst leaf's gap of two {module: {leaf: norm}}
    readings."""
    out = {}
    for m, leaves in ref.items():
        kept = [n for n in leaves if n in keep.get(m, ())]
        median = statistics.median(leaves[n] for n in kept)
        worst = 0.0
        for n in kept:
            p = prog.get(m, {}).get(n, math.nan)
            gap = abs(p - leaves[n]) / max(leaves[n], median, 1e-30)
            worst = max(worst, gap) if math.isfinite(gap) else math.inf
        out[m] = worst
    return out


def kept_leaves(ref) -> Dict[str, List[str]]:
    """Per module, the leaves whose first gradient in the reference is at
    least EXCLUDE_BELOW of its median leaf's."""
    keep = {}
    for m, leaves in ref["grad1"].items():
        median = statistics.median(leaves.values())
        keep[m] = [n for n, v in leaves.items()
                   if v >= EXCLUDE_BELOW * median]
    return keep


def records_gaps(prog, ref) -> torch.Tensor:
    """Each (step, env) record's gap over the reference's record or its
    median magnitude, whichever is larger (not finite: inf)."""
    scale = max(float(ref.abs().median()), 1e-30)
    gap = (prog - ref).abs() / torch.clamp(ref.abs(), min=scale)
    return torch.nan_to_num(gap.flatten(), nan=math.inf)


def records_gap(prog, ref) -> float:
    if prog is None or prog.shape != ref.shape:
        return math.inf
    return float(torch.quantile(records_gaps(prog, ref), RECORDS_QUANTILE))


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    out = {}
    for k in ref["losses"][0]:
        gaps = []
        for p, r in zip(prog["losses"], ref["losses"]):
            g = abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
            gaps.append(g if math.isfinite(g) else math.inf)
        gaps += [math.inf] * (len(ref["losses"]) - len(gaps))
        out[f"{k}1_gap"] = gaps[0]
        out[f"{k}_gap"] = max(gaps)
    for k, r in ref["records1"].items():
        out[f"{k}1_p999_gap"] = records_gap(prog["records1"].get(k), r)
    keep = kept_leaves(ref)
    for m, gap in _leaf_gaps(prog["grad1"], ref["grad1"], keep).items():
        out[f"grad1_gap.{m}"] = gap
    out["dparam_gap"] = max(_leaf_gaps(prog["dparam"], ref["dparam"],
                                       keep).values())
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]): correct when every number the
    limits name is finite and at most its limit."""
    rows = [(k, numbers.get(k, math.inf), float(v))
            for k, v in sorted(limits.items())]
    ok = all(math.isfinite(n) and n <= lim for _, n, lim in rows)
    return ok, rows
