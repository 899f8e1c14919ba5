"""kernels: K4's share of its roofline, in %: the least time of one search
at the cell's shape (``rooflines/adc.py``: the batch, the rows held, the
codec's subspaces and codewords, one byte a code up to 256 codewords, else
two) times the profiled launches of the lookup core, over the profiler's
time of the core, its table interleave, its splits' merge and
``lane8_merge``.  Nothing where the core did not run."""


def read(ctx):
    rf = ctx.bench.roofline('adc')
    sec, launches = ctx.kernels(rf.KERNELS)
    n = launches[rf.LAUNCH]
    if n == 0 or sec <= 0:
        return None
    kw = ctx.config['annlite']
    k = int(kw.get('n_clusters', 256))
    bound = rf.bound_s(int(ctx.mix['batch']), int(ctx.config['n_docs']),
                       int(kw['n_subvectors']), k, 1 if k <= 256 else 2)
    return 100.0 * bound * n / sec
