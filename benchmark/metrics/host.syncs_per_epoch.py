"""Host-device synchronizations in the profiled epoch: the port's
``host.syncs`` counts (torch's sync detector, on only inside the
trainers' root spans while a profiler is active, each sync counted
against the innermost open span) summed over the epoch's spans, less
those in or under a ``trainer.save`` span (``harness/spans.syncs``): an
epoch writes a new best policy only a minute or more after the last such
write, and the write reads every tensor back, so with them the count
would not repeat. Nothing where the port records no spans."""

from benchmark.harness.spans import epoch_spans, syncs


def read(ctx):
    recs = epoch_spans(ctx.trace)
    return float(syncs(recs)) if recs else None
