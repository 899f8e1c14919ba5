"""storage layer: mean ms of the program's spans `annlite.storage.*` (the id
map and the doc reads) per request of the traced window (`program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.ms_per_request('annlite.storage.', prefix=True)
