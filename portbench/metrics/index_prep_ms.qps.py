"""index layer: mean self ms of `annlite.index.prep` per request of the traced
window: the host's work before the first launch (mask, searcher, query), the
waits of its uploads left to `index_wait_ms` (`program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.ms_per_request('annlite.index.prep', self_time=True)
