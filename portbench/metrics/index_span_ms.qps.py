"""index layer: mean ms of the program's span `annlite.index` per request of
the traced window, the wait for the card included (`program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.ms_per_request('annlite.index')
