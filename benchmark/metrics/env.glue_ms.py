"""Host-clock milliseconds of the port's ``env.step`` spans less their
children's (the simulator's ``sim.simulate``) over the profiled epoch: the
env's glue around the simulator, its controls, observations, reward,
termination and in-graph reset. Taken under the profiler, which slows the
host (a SHAC epoch of 10.4-12.0 s profiled against 7.5-8.4 s without).
Nothing where the port records no spans (``harness/spans.py``)."""

from benchmark.harness.spans import epoch_spans, self_ms


def read(ctx):
    recs = epoch_spans(ctx.trace)
    return self_ms(recs, "env.step") if recs else None
