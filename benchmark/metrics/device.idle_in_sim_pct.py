"""The share of the card's idle time in the profiled epoch that falls in
the simulator, in percent: each stretch in which no kernel, copy or fill
ran (from the epoch's first span to its last, ``harness/spans.py``) is
given to the innermost of the port's spans open at its midpoint on any
thread (the latest started), and counted here when that span's name
begins with ``sim.``. The host runs under the profiler, which slows it.
Nothing where the port records no spans."""

from benchmark.harness.spans import epoch_spans, idle_pct


def read(ctx):
    recs = epoch_spans(ctx.trace)
    if not recs:
        return None
    return idle_pct(ctx.trace, recs,
                    lambda name: name is not None and name.startswith("sim."))
