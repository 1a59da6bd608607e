"""Runs one cell of the port's benchmark once and prints its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, limits and per-layer metric
readers are found by name (``harness/spec.py``). The last line of
standard output is one JSON object; the last lines of standard error are
the numbers of the check beside their limits. A run needs CUDA and the
cards the cell asks for; without them it prints no result and exits 3.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from benchmark.harness import cell_run, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = cell_run.run(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0)
    except cell_run.ImportRuleError as e:
        print(f"import rule broken: {e}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
