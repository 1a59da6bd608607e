#!/usr/bin/env python3
"""Where one benchmark cell's profiled epoch spends the card's idle time,
by the port's own spans (``diffrl_tpu_torch/utils/time_report.py``).

    python3 tools/span_breakdown.py --workload ant.shac_65536 --seed 7 \
        [--out spans.json]

Needs one CUDA device. Builds the cell's trainer from the seed as
``benchmark/run.py`` does and runs its set-up epochs, then profiles one
epoch as ``--trace 1`` does (``benchmark/harness/trace.profile_epoch``) and
prints, with the benchmark's own arithmetic (``benchmark/harness/spans.py``):

- the card's idle time by the innermost span open at each gap's midpoint,
  the share in ``sim.*`` spans and the share that no span covers;
- per span name: calls, host milliseconds in all and less their
  children, the K1 and K2 launches they carry, the host syncs counted in
  them; beside them the trace's counts of ``substep_forward_kernel`` and
  ``substep_vjp_kernel``, and the epoch's syncs as
  ``host.syncs_per_epoch`` reads them;
- where the syncs happened (file and line of the call).

The JSON of all of it goes to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _table(trace, recs):
    from benchmark.harness import spans as S

    idle = S.idle_by_span(trace, recs)
    rows = {}
    for name in sorted({r.name for r in recs}):
        mine = [r for r in recs if r.name == name]
        rows[name] = dict(
            calls=len(mine), ms=S.total_ms(recs, name),
            self_ms=S.self_ms(recs, name),
            **{k: sum(r.count(f"{k}.launches") for r in mine)
               for k in ("k1", "k2")},
            syncs=sum(r.count("host.syncs") for r in mine))
    return dict(
        idle_s=sum(idle.values()), busy_s=trace.busy_s,
        window_s=trace.window_s,
        idle_by_span={str(k): v for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
        uncovered_pct=S.idle_pct(trace, recs, lambda n: n is None),
        in_sim_pct=S.idle_pct(
            trace, recs, lambda n: n is not None and n.startswith("sim.")),
        spans=rows, syncs_per_epoch=S.syncs(recs),
        trace_k1=len(trace.kernels("substep_forward_kernel")),
        trace_k2=len(trace.kernels("substep_vjp_kernel")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cell_run, check, spec
    from benchmark.harness import spans as S
    from benchmark.harness.subjects import ProgramTrainer
    from benchmark.harness.trace import profile_epoch
    from diffrl_tpu_torch.utils import time_report

    sites = collections.Counter()
    show = time_report._SyncCounter._show

    def located(self, message, category, filename, lineno, *a, **k):
        if time_report.SYNC_WARNING in str(message):
            sites[f"{os.path.relpath(filename, ROOT)}:{lineno}"] += 1
        return show(self, message, category, filename, lineno, *a, **k)
    time_report._SyncCounter._show = located

    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    subject = ProgramTrainer(cell, args.seed, tempfile.mkdtemp(), device)
    check.read(subject, int(cell.traffic["check_epochs"]))
    subject.epoch()

    time_report.clear()
    trace = profile_epoch(subject.epoch, True)
    recs = S.epoch_spans(trace)
    out = dict(workload=args.workload, seed=args.seed,
               card=f"{torch.cuda.get_device_name(device)}, "
                    f"{cell_run.card_power_limit()}",
               torch=torch.__version__, **_table(trace, recs),
               sync_sites=dict(sites.most_common()), spans_per_epoch=len(recs))
    subject.close()

    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
