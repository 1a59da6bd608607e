"""PPO's update (``PPO.update``: GAE, the statistics, the minibatch
steps): host-clock milliseconds per epoch, the host waiting for the device
before and after, over the traced run's unprofiled epochs."""


def read(ctx):
    return ctx.phase_ms.get("update")
