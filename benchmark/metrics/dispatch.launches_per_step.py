"""Kernels the host launched per batched env step: the device trace's
kernels in the profiled epoch (copies and fills left out) over its
``steps_num`` env steps. A count that repeats exactly."""


def read(ctx):
    if ctx.trace is None:
        return None
    kernels = [n for _, _, n in ctx.trace.device
               if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) / ctx.steps_num
