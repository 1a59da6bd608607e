"""Readings that the cells' limits are set from, at the cells' own sizes
on the card: for each seed, the plain reference's first epochs in float64
against the port's (``program``), against the reference in float32 with
TF32 matmuls in the program's place (``control``: the nearest precision
below the configuration's float32 with TF32 off), against the reference
in float32 without TF32 (``plain32``: the port's plain arithmetic, a
witness that sides with neither kernel), and against the port with a fault
planted (``harness/faults.py``). One JSON line per seed and
subject goes to standard output and to ``--out``.

    python benchmark/calibrate.py --workload ant.shac_65536 --epochs 1 \
        --seeds 11,12,13 --subjects program,control,scaled_adjoint \
        --out "$TMPDIR/calibrate.jsonl"

The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, subject, device, epochs):
    """(readings, seconds) of one subject of one seed over ``epochs``."""
    import torch

    from benchmark.harness import check
    from benchmark.harness.faults import FAULTS
    from benchmark.harness.subjects import ProgramTrainer, ReferenceTrainer

    t = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        if subject == "reference":
            s = ReferenceTrainer(cell, seed, device, torch.float64)
        elif subject == "control":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            s = ReferenceTrainer(cell, seed, device, torch.float32)
        elif subject == "plain32":
            s = ReferenceTrainer(cell, seed, device, torch.float32)
        else:
            logdir = tempfile.mkdtemp(prefix="benchmark_calibrate_")
            s = ProgramTrainer(cell, seed, logdir, device,
                               FAULTS.get(subject))
        out = check.read(s, epochs, keep_state=True)
        s.close()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    del s
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out, time.perf_counter() - t


def quantiles(rec, rec_ref):
    """Quantiles of a first-epoch record's per-(step, env) gap."""
    import torch

    from benchmark.harness.check import records_gaps

    gap = records_gaps(rec, rec_ref)
    qs = (0.5, 0.9, 0.99, 0.999, 1.0)
    return {str(q): float(torch.quantile(gap, q)) for q in qs}


def divergence(q, q_ref):
    """How far each env's joint coordinates after the epochs lie from the
    reference's: the count of envs past each threshold of the largest
    |difference|, and the largest ones."""
    import torch

    d = (q - q_ref).abs().amax(dim=1)
    d = torch.nan_to_num(d, nan=float("inf"))
    return {"envs": int(d.numel()),
            "over": {t: int((d > float(t)).sum())
                     for t in ("1e-6", "1e-4", "1e-2", "1")},
            "largest": sorted(d.tolist(), reverse=True)[:8]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--subjects", default="program,control")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs to read (default: the mix's check_epochs; "
                        "1 reads every number of the first epoch)")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import check, spec

    cell = spec.load_cell(args.workload, ROOT)
    epochs = args.epochs or int(cell.traffic["check_epochs"])
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        ref, ref_s = readings(cell, seed, "reference", args.device, epochs)
        for subject in args.subjects.split(","):
            got, s = readings(cell, seed, subject, args.device, epochs)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "subject": subject, "epochs": epochs,
                               "numbers": check.compare(got, ref),
                               "seconds": s, "reference_seconds": ref_s,
                               "losses": got["losses"],
                               "reference_losses": ref["losses"],
                               "leaves": {k: got[k] for k in ("grad1",
                                                              "dparam")},
                               "records1_quantiles": {
                                   k: quantiles(got["records1"][k], r)
                                   for k, r in ref["records1"].items()},
                               "reference_leaves": {
                                   k: ref[k] for k in ("grad1", "dparam")},
                               "divergence": divergence(got["env_q"],
                                                        ref["env_q"])})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
