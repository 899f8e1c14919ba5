"""index layer: mean ms per request of the traced window in which the host
blocks on the card: the spans `annlite.index.wait` (uploads, termination
checks, the results' copy back; `program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.ms_per_request('annlite.index.wait')
