"""The share of the profiled epoch's host-clock window in which no kernel,
copy or fill ran on the card (the union of the device intervals), in
percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
