"""index layer: mean ms of `annlite.index.fallback` per request of the traced
window: a filtered graph search's masked exact scan, below the index's
`filter_fallback_selectivity`, inside `annlite.index.dispatch`
(`program.py`).  Nothing where the program records no such span."""
import numpy as np

from portbench import program

SPAN = 'annlite.index.fallback'


def read(ctx):
    w = program.window(ctx)
    if w is None or not np.any(w.rec['name'] == SPAN):
        return None
    return w.ms_per_request(SPAN)
