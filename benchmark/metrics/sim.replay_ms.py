"""Host-clock milliseconds in the port's ``sim.replay`` spans over the
profiled epoch: the simulator's reverse pass (``_SimulateReplay.backward``:
each block's K2 launches and its refresh replayed under autograd), the
simulator's share of ``shac.window_bwd_ms``. Taken under the profiler,
which slows the host (a SHAC epoch of 10.4-12.0 s profiled against
7.5-8.4 s without). Nothing where the epoch replays nothing or the port
records no spans (``harness/spans.py``)."""

from benchmark.harness.spans import epoch_spans, total_ms


def read(ctx):
    recs = epoch_spans(ctx.trace)
    return total_ms(recs, "sim.replay") if recs else None
