"""index layer: times the host waits on the card per request of the traced
window (the program's counter `host_syncs`, one per wait span; `program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.per_request('host_syncs')
