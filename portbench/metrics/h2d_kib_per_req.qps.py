"""index layer: KiB a request copies from the host to the card, over the
traced window (the program's counter `h2d_bytes`; `program.py`)."""
from portbench import program


def read(ctx):
    w = program.window(ctx)
    return None if w is None else w.per_request('h2d_bytes') / 1024.0
