"""facade layer: mean self ms per request of the traced window (host spans)."""


def read(ctx):
    return ctx.layer_ms('facade')
