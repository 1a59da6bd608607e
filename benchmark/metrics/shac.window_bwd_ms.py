"""SHAC's reverse pass and actor update (``SHAC.actor_step``: the replay,
K2, the clip and Adam): host-clock milliseconds per epoch, the host
waiting for the device before and after, over the traced run's unprofiled
epochs."""


def read(ctx):
    return ctx.phase_ms.get("actor_step")
