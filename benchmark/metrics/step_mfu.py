"""The whole training step's share of the card's float32 peak: one epoch's
floating-point operations, counted from the model's topology and the
networks whatever implements them (``harness/counts.py``), over the mean
host-clock time of the traced run's unprofiled epochs times 67 TFLOP/s,
in percent. The card's power limit is in the result's ``device``."""

from benchmark.harness.counts import EPOCH_FLOPS, PEAK_FLOPS_FP32


def read(ctx):
    if ctx.model is None or ctx.epochs == 0:
        return None
    flops = EPOCH_FLOPS[ctx.cell.trainer](
        ctx.model, ctx.cfg, ctx.cell.config["model"], ctx.num_envs,
        ctx.n_active_per_launch)
    return 100.0 * flops / (ctx.window_s / ctx.epochs * PEAK_FLOPS_FP32)
