"""Profiling utilities; the port's copy of `annlite_tpu/profile.py`.

Reference `annlite/profile.py:20-70` wraps cProfile; here we keep that and add
a ``torch.profiler`` trace context for on-device profiling.
"""
import cProfile
import contextlib
import functools
import io
import pstats
import time
from pathlib import Path


def time_profile(func=None, *, output_file: str = None, sort_by: str = 'cumulative', lines: int = 50):
    """cProfile decorator: dumps ``.prof`` + pstats text report."""

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            prof = cProfile.Profile()
            prof.enable()
            try:
                return f(*args, **kwargs)
            finally:
                prof.disable()
                path = output_file or (f.__name__ + '.prof')
                prof.dump_stats(path)
                s = io.StringIO()
                pstats.Stats(prof, stream=s).sort_stats(sort_by).print_stats(lines)
                with open(path + '.txt', 'w') as fh:
                    fh.write(s.getvalue())

        return wrapper

    if func is not None:
        return decorator(func)
    return decorator


@contextlib.contextmanager
def time_context(name: str, logger=None):
    """Wall-clock timing block (replaces jina TimeContext)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f'{name} took {dt:.4f}s'
    if logger is not None:
        logger.info(msg)
    else:
        print(msg)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the host and, where there is a card, of
    the device; writes a Chrome trace (``trace.json``) under ``logdir``
    (open it in Perfetto or ``chrome://tracing``).  Yields the profiler, so
    the block can read ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / 'trace.json'))
