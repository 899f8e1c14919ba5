"""Profiling utilities; the port's copy of `annlite_tpu/profile.py`, and
the port's tracer.

Reference `annlite/profile.py:20-70` wraps cProfile; here we keep that and add
a ``torch.profiler`` trace context for on-device profiling.

The tracer is the one place the program records where its time goes: named
spans (:func:`span`) around its stages and counters (:func:`count`) at the
same boundaries, always on (:func:`set_enabled` switches it).  A span
records its name, start and end (``time.perf_counter_ns``), its parent and
its request, the root span of its thread's stack, into a ring of fixed size
(:func:`records`); every span's count and total time, and every counter, are
also summed for the life of the process (:func:`snapshot`).  Each thread
keeps its own stack.  While ``torch.profiler`` records, a span also enters
``record_function(name)``, so it sits in the profiler's trace, on its
clock, around the work it launched.

Names (``PERF.md`` §3): a search is the root ``annlite.search`` with
``annlite.filter``, ``annlite.index`` (``.prep``, ``.dispatch``, ``.wait``
where the host blocks on the card) and ``annlite.storage.idmap`` /
``.docs``; an ingest the root ``annlite.ingest`` with ``annlite.ingest.store``
and ``annlite.ingest.index`` (the device build's ``annlite.build.<stage>``).
Counters: ``host_syncs`` (one per wait span), ``h2d_bytes``, ``graph.iters``,
``launch.<kernel>`` and ``kernels_built``.
"""
import cProfile
import contextlib
import functools
import io
import itertools
import pstats
import threading
import time
from array import array
from pathlib import Path
from typing import Dict

import numpy as np
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


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


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

WAIT = 'annlite.index.wait'
# counters also kept per request, on the root span's record
REQUEST_COUNTERS = ('host_syncs', 'h2d_bytes', 'graph.iters')
_REQUEST_COL = {name: i for i, name in enumerate(REQUEST_COUNTERS)}
# records the ring holds: 2**17, 67 bytes each (8.4 MiB): a run of a
# benchmark cell, ~10 spans a request, with room to spare
RING_RECORDS = 1 << 17


class _ThreadState:
    """One thread's open spans, counters and span totals."""

    __slots__ = ('stack', 'counts', 'totals')

    def __init__(self):
        self.stack = []
        self.counts: Dict[str, int] = {}
        self.totals: Dict[int, list] = {}  # name id -> [count, ns]


class _Span:
    """One span of a tracer (:meth:`Tracer.span`); written to the ring when
    it closes."""

    __slots__ = ('_tr', '_nid', '_seq', '_parent', '_req', '_t0', '_rf', '_acc', '_st')

    def __init__(self, tracer: 'Tracer', nid: int):
        self._tr = tracer
        self._nid = nid
        self._seq = -1

    def __enter__(self):
        tr = self._tr
        if not tr.enabled:
            return self
        try:
            st = tr._local.st
        except AttributeError:
            st = tr._state()
        stack = st.stack
        self._st = st
        self._seq = seq = next(tr._seq)
        if stack:
            top = stack[-1]
            self._parent, self._req, self._acc = top._seq, top._req, None
        else:
            self._parent, self._req, self._acc = -1, seq, [0] * len(REQUEST_COUNTERS)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(tr._names[self._nid])
            self._rf.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        seq = self._seq
        if seq < 0:
            return False
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        st = self._st
        st.stack.pop()
        tr = self._tr
        i = seq % tr.capacity
        tr._rseq[i] = seq
        tr._t0[i] = self._t0
        tr._t1[i] = t1
        tr._parent[i] = self._parent
        tr._req[i] = self._req
        tr._name[i] = self._nid
        acc = self._acc
        if acc is None:
            tr._flag[i] = 0
        else:
            tr._flag[i] = 1 + (self._rf is not None)
            for col, v in zip(tr._rc, acc):
                col[i] = v
        tot = st.totals.get(self._nid)
        if tot is None:
            st.totals[self._nid] = [1, t1 - self._t0]
        else:
            tot[0] += 1
            tot[1] += t1 - self._t0
        return False


class Tracer:
    """Spans into a ring of ``capacity`` records, and counters.  The program
    records into the module's one tracer (:func:`span`, :func:`count`);
    tests make their own."""

    def __init__(self, capacity: int = RING_RECORDS):
        self.capacity = capacity
        self.enabled = True
        self._seq = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._threads = []
        self._names = []
        self._ids: Dict[str, int] = {}
        q = array('q', [0]) * capacity
        self._rseq = array('q', [-1]) * capacity
        self._t0, self._t1, self._parent, self._req = q, q[:], q[:], q[:]
        self._name = array('H', [0]) * capacity
        # 0: a child span, 1: a root, 2: a root that ran under the profiler
        self._flag = array('b', [0]) * capacity
        self._rc = [q[:] for _ in REQUEST_COUNTERS]

    def nbytes(self) -> int:
        """Host bytes of the ring."""
        cols = [self._rseq, self._t0, self._t1, self._parent, self._req, self._name,
                self._flag, *self._rc]
        return sum(c.itemsize * len(c) for c in cols)

    def _state(self) -> _ThreadState:
        try:
            return self._local.st
        except AttributeError:
            st = self._local.st = _ThreadState()
            with self._lock:
                self._threads.append(st)
            return st

    def _nid(self, name: str) -> int:
        nid = self._ids.get(name)
        if nid is None:
            with self._lock:
                nid = self._ids.get(name)
                if nid is None:
                    nid = len(self._names)
                    self._names.append(name)
                    self._ids[name] = nid
        return nid

    def span(self, name: str) -> _Span:
        """A context manager that records ``name`` around its block."""
        nid = self._ids.get(name)
        return _Span(self, self._nid(name) if nid is None else nid)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to counter ``name`` (and, for :data:`REQUEST_COUNTERS`,
        to the open request of this thread)."""
        if not self.enabled:
            return
        try:
            st = self._local.st
        except AttributeError:
            st = self._state()
        c = st.counts
        c[name] = c.get(name, 0) + n
        if st.stack:
            col = _REQUEST_COL.get(name)
            if col is not None:
                st.stack[0]._acc[col] += n

    def wait(self) -> _Span:
        """A wait span: the host blocks on the card inside it."""
        self.count('host_syncs')
        return self.span(WAIT)

    def current(self):
        """Names of this thread's open spans, outermost first."""
        return [self._names[s._nid] for s in self._state().stack]

    def snapshot(self) -> Dict:
        """Counters, and each span name's count and total ns, summed over
        every thread since the process started."""
        with self._lock:
            threads = list(self._threads)
            names = list(self._names)
        counters: Dict[str, int] = {}
        spans: Dict[str, Dict[str, int]] = {}
        for st in threads:
            for k, v in st.counts.copy().items():
                counters[k] = counters.get(k, 0) + v
            for nid, (n, ns) in st.totals.copy().items():
                agg = spans.setdefault(names[nid], {'count': 0, 'total_ns': 0})
                agg['count'] += n
                agg['total_ns'] += ns
        return {'counters': counters, 'spans': spans}

    def records(self) -> Dict[str, np.ndarray]:
        """The ring's closed spans in the order they opened: ``seq``,
        ``name``, ``t0``/``t1`` (ns), ``parent`` and ``request`` (seqs; -1:
        none), ``root``, ``profiled`` and, on roots, the request counters.
        ``first`` is the oldest seq from which every closed span is still
        held (0 until the ring wrapped)."""
        seq = np.frombuffer(self._rseq, dtype=np.int64).copy()
        cols = {'t0': self._t0, 't1': self._t1, 'parent': self._parent,
                'request': self._req, 'name_id': self._name, 'flag': self._flag,
                **dict(zip(REQUEST_COUNTERS, self._rc))}
        cols = {k: np.frombuffer(v, dtype=np.dtype(v.typecode)).copy()
                for k, v in cols.items()}
        keep = seq >= 0
        first = max(0, int(seq.max()) + 1 - self.capacity) if keep.any() else 0
        keep &= seq >= first
        order = np.argsort(seq[keep], kind='stable')
        out = {k: v[keep][order] for k, v in cols.items()}
        out['seq'] = seq[keep][order]
        names = np.asarray(list(self._names) or [''], dtype=object)
        out['name'] = names[out.pop('name_id')]
        flag = out.pop('flag')
        out['root'] = flag > 0
        for c in REQUEST_COUNTERS:  # a child's slot keeps a stale root's counts
            out[c][~out['root']] = 0
        out['profiled'] = flag == 2
        out['first'] = first
        return out


_TRACER = Tracer()
# the program's tracer, as functions (see the module's docstring)
span = _TRACER.span
count = _TRACER.count
wait = _TRACER.wait
snapshot = _TRACER.snapshot
records = _TRACER.records
current = _TRACER.current


def upload(a: np.ndarray, device):
    """``a`` as a tensor on ``device``: the copy counted in ``h2d_bytes``
    and, since a copy from pageable memory blocks the host, inside a wait."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    _TRACER.count('h2d_bytes', t.nbytes)
    with _TRACER.wait():
        return t.to(device)


def set_enabled(on: bool) -> bool:
    """Switch recording on or off; returns the previous setting."""
    was, _TRACER.enabled = _TRACER.enabled, bool(on)
    return was
