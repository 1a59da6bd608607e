"""K2 (``substep_vjp_kernel``, the cached substep's adjoint): the least time
one launch could take, the larger of its operations (the forward once,
the adjoint arithmetic, and the adjoints of the contacts below the ground,
counted at the env states of the profiled epoch's steps) over the float32
peak and its bytes over the memory bandwidth, over its mean device time in
the profiled epoch, in percent. Nothing when the epoch launched none."""

from benchmark.harness.counts import (PEAK_BYTES, PEAK_FLOPS_FP32,
                                      substep_vjp_bytes, substep_vjp_flops)


def read(ctx):
    times = ctx.trace.kernels("substep_vjp_kernel") if ctx.trace else []
    if not times:
        return None
    E = ctx.num_envs
    flops = substep_vjp_flops(ctx.model, E, round(ctx.n_active_per_launch))
    least = max(flops / PEAK_FLOPS_FP32,
                substep_vjp_bytes(ctx.model, E) / PEAK_BYTES)
    return 100.0 * least / (sum(times) / len(times))
