"""K1 (``substep_forward_kernel``, the cached substep's forward): the least
time one launch could take on the card, the larger of its operations over
the float32 peak and its bytes over the memory bandwidth (the counts in
``harness/counts.py``), over its mean device time in the profiled epoch,
in percent. Nothing when the epoch launched none."""

from benchmark.harness.counts import (PEAK_BYTES, PEAK_FLOPS_FP32,
                                      substep_forward_bytes,
                                      substep_forward_flops)


def read(ctx):
    times = ctx.trace.kernels("substep_forward_kernel") if ctx.trace else []
    if not times:
        return None
    E = ctx.num_envs
    least = max(substep_forward_flops(ctx.model, E) / PEAK_FLOPS_FP32,
                substep_forward_bytes(ctx.model, E) / PEAK_BYTES)
    return 100.0 * least / (sum(times) / len(times))
