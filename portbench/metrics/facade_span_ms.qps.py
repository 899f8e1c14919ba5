"""facade layer: mean self ms of the program's root span `annlite.search`
per request of the traced window (the program's own spans, `program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.ms_per_request(program.SEARCH, self_time=True)
