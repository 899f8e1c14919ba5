"""device: kernels launched per request over the profiled requests."""


def read(ctx):
    tr = ctx.device()
    return None if tr is None else tr['launches'] / tr['requests']
