"""Process start to the first timed request: data, ingest, build, warm-up
(and, in the first run of a checkout, the kernels' compilation)."""


def read(w):
    return w['setup_s']
