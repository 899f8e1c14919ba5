"""index layer: seconds of the run's ingest in `annlite.ingest.index` (the
index's add, the graph's device build included; `program.py`)."""
from portbench import program


def read(ctx):
    w = program.ingest(ctx)
    return None if w is None else w.total_ns('annlite.ingest.index') * 1e-9
