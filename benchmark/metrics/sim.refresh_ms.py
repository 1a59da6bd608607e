"""Host-clock milliseconds in the port's ``sim.refresh`` spans over the
profiled epoch: the plain refresh substep's forward (the mass matrix, its
factorization and one substep, dispatched op by op), once per block of
every env step. Taken under the profiler, which slows the host (a SHAC
epoch of 10.4-12.0 s profiled against 7.5-8.4 s without). Nothing where
the port records no spans (``harness/spans.py``)."""

from benchmark.harness.spans import epoch_spans, total_ms


def read(ctx):
    recs = epoch_spans(ctx.trace)
    return total_ms(recs, "sim.refresh") if recs else None
