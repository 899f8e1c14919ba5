"""index layer: mean self ms of `annlite.index.dispatch` per request of the
traced window: the host issuing the work, the waits inside it (a traversal's
termination checks) left to `index_wait_ms` (`program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.ms_per_request('annlite.index.dispatch', self_time=True)
