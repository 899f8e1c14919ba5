"""storage layer: seconds of the run's ingest in `annlite.ingest.store` (the
cell table, the address table and the doc store; `program.py`)."""
from portbench import program


def read(ctx):
    w = program.ingest(ctx)
    return None if w is None else w.total_ns('annlite.ingest.store') * 1e-9
