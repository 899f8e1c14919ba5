"""device: share of the profiled window in which no kernel, memcpy or memset
ran on the card, in %."""


def read(ctx):
    tr = ctx.device()
    return None if tr is None else 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
