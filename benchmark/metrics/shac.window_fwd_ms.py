"""SHAC's window forward (``SHAC.rollout``): host-clock milliseconds per
epoch, the host waiting for the device before and after, over the traced
run's unprofiled epochs."""


def read(ctx):
    return ctx.phase_ms.get("rollout")
