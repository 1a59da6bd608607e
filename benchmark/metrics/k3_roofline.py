"""K3 (``mass_matrix_vjp_kernel``, the mass matrix's adjoint in the
refresh's reverse pass): the least time one launch could take on the card,
the larger of its operations over the float32 peak and its bytes over the
memory bandwidth (the counts in ``harness/counts_k3.py``), over its mean
device time in the profiled epoch, in percent. Nothing when the epoch
launched none."""

from benchmark.harness.counts import PEAK_BYTES, PEAK_FLOPS_FP32
from benchmark.harness.counts_k3 import (mass_matrix_vjp_bytes,
                                         mass_matrix_vjp_flops)


def read(ctx):
    times = ctx.trace.kernels("mass_matrix_vjp_kernel") if ctx.trace else []
    if not times:
        return None
    E = ctx.num_envs
    least = max(mass_matrix_vjp_flops(ctx.model, E) / PEAK_FLOPS_FP32,
                mass_matrix_vjp_bytes(ctx.model, E) / PEAK_BYTES)
    return 100.0 * least / (sum(times) / len(times))
