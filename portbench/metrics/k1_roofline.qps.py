"""kernels: K1's share of its roofline, in %: the least time of its block
passes at the cell's rows, dimension and batch (``rooflines/k1.py``) over
the profiler's time of ``block_top2`` (with its split merge) and
``lane8_merge``.  Nothing where K1 did not run."""


def read(ctx):
    k1 = ctx.bench.roofline('k1')
    sec, launches = ctx.kernels(k1.KERNELS)
    n = launches[k1.LAUNCH]
    if n == 0 or sec <= 0:
        return None
    bound = k1.bound_s(ctx.config['n_docs'], ctx.config['annlite']['n_dim'], ctx.mix['batch'])
    return 100.0 * bound * n / sec
