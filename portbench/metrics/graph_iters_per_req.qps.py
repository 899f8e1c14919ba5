"""index layer: iterations of the graph's eager traversal loop per request of
the traced window (the program's counter `graph.iters`; `program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.per_request('graph.iters')
