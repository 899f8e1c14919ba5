"""set-up: seconds of the run's codec training, the program's root span
`annlite.train` (each codec's fit and the dump of its file), read from the
program's tracer over `program.ring()`: the last such root, where the next
root after it is the run's first `annlite.ingest` (the harness trains just
before it ingests).  Nothing where the configuration trains nothing, where
the program has no such span, or where the ring no longer holds it."""
import numpy as np

from portbench import program

TRAIN = 'annlite.train'


def read(ctx):
    if 'train' not in ctx.config:
        return None
    rec = program.ring()
    if rec is None:
        return None
    roots = np.flatnonzero(rec['root'])
    names = rec['name'][roots]
    hits = np.flatnonzero(names == TRAIN)
    if len(hits) == 0:
        return None
    last = hits[-1]
    if last + 1 >= len(roots) or names[last + 1] != program.INGEST:
        return None
    i = roots[last]
    return float(rec['t1'][i] - rec['t0'][i]) * 1e-9
