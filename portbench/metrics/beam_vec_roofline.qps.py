"""kernels: ``beam_vec``'s share of its roofline, in %: the least time of a
launch at the cell's shape (``rooflines/beam_vec.py``: the batch, the list
width ef = max(ef_search, 4 limit) as the graph index sets it, the rows'
width, float32 rows without a codec and bf16 beside one, a predicate byte a
row where the traffic filters) times the profiled launches, over the
profiler's time of ``beam_vec_kernel``.  Nothing where it did not run."""


def read(ctx):
    rf = ctx.bench.roofline('beam_vec')
    sec, launches = ctx.kernels((rf.KERNEL,))
    n = launches[rf.KERNEL]
    if n == 0 or sec <= 0:
        return None
    kw = ctx.config['annlite']
    limit = int(ctx.mix['limit'])
    bound = rf.bound_s(int(ctx.mix['batch']), max(int(kw['ef_search']), 4 * limit),
                       int(kw['n_dim']), 2 if kw.get('n_subvectors') else 4,
                       1 if ctx.mix.get('filter') else 0, limit)
    return 100.0 * bound * n / sec
