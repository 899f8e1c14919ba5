"""index layer: queries a request of the traced window sends to a filtered
graph search's masked exact scan (the program's counter
`graph.fallback_queries`; `program.py`).  Nothing where the program keeps no
such counter."""
from portbench import program

COUNTER = 'graph.fallback_queries'


def read(ctx):
    w = program.window(ctx)
    if w is None or COUNTER not in w.rec:
        return None
    return w.per_request(COUNTER)
