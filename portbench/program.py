"""The program's own spans and counters, as the per-layer readers in
``metrics/`` read them.

``annlite_torch/profile.py`` records every span of the program into a ring
of fixed size (:func:`ring`).  A reader takes from it the traced run's
window, the last ``len(ctx.spans)`` roots ``annlite.search`` that did not run
under the profiler (the requests the harness's own spans average over), or
the run's ingest, the roots ``annlite.ingest`` just before the warm-up.

Every reader returns None without a card's trace (on a CPU the dispatch and
the waits fold into each other), where the program has no tracer, and where
the ring no longer holds the run's records.
"""
from typing import Dict, Optional

import numpy as np

SEARCH = 'annlite.search'
INGEST = 'annlite.ingest'


def ring() -> Optional[Dict[str, np.ndarray]]:
    """The tracer's records, or None where the program has no tracer."""
    try:
        from annlite_torch import profile
    except ImportError:
        return None
    records = getattr(profile, 'records', None)
    return None if records is None else records()


class Requests:
    """The records of a set of roots (``roots``: positions in ``rec``)."""

    def __init__(self, rec: Dict[str, np.ndarray], roots: np.ndarray):
        self.rec, self.roots, self.n = rec, roots, len(roots)
        self.member = np.isin(rec['request'], rec['seq'][roots])
        dur = rec['t1'] - rec['t0']
        # time of each record's direct children: its self time is the rest
        child = np.zeros(len(dur), dtype=np.int64)
        has = rec['parent'] >= 0
        pos = np.minimum(np.searchsorted(rec['seq'], rec['parent'][has]), max(len(dur) - 1, 0))
        held = rec['seq'][pos] == rec['parent'][has]
        np.add.at(child, pos[held], dur[has][held])
        self.dur, self.self_ns = dur, dur - child

    def _of(self, name: str, prefix: bool) -> np.ndarray:
        names = self.rec['name']
        uniq, inv = np.unique(names, return_inverse=True)
        hit = np.array([(u.startswith(name) if prefix else u == name) for u in uniq], dtype=bool)
        return self.member & hit[inv]

    def total_ns(self, name: str, self_time: bool = False, prefix: bool = False) -> float:
        """Summed ns of spans ``name`` (or starting with it) in these requests."""
        sel = self._of(name, prefix)
        return float((self.self_ns if self_time else self.dur)[sel].sum())

    def ms_per_request(self, name: str, self_time: bool = False, prefix: bool = False) -> float:
        return self.total_ns(name, self_time, prefix) / self.n * 1e-6

    def per_request(self, counter: str) -> float:
        """Mean of a request counter (``profile.REQUEST_COUNTERS``) over the roots."""
        return float(self.rec[counter][self.roots].mean())


def window(ctx) -> Optional[Requests]:
    """The traced window's requests, or None (see the module's docstring)."""
    if ctx.device() is None or not ctx.spans:
        return None
    rec = ring()
    if rec is None:
        return None
    roots = np.flatnonzero(rec['root'] & (rec['name'] == SEARCH) & ~rec['profiled'])
    n = len(ctx.spans)
    if len(roots) < n:
        return None  # the ring dropped some of the window
    return Requests(rec, roots[-n:])


def ingest(ctx) -> Optional[Requests]:
    """The run's ingest: the block of ``annlite.ingest`` roots last before
    the window's warm-up, or None."""
    w = window(ctx)
    if w is None:
        return None
    rec = w.rec
    roots = np.flatnonzero(rec['root'] & (rec['seq'] < rec['seq'][w.roots[0]]))
    names = rec['name'][roots]
    end = len(roots) - 1
    while end >= 0 and names[end] != INGEST:  # back over the warm-up
        end -= 1
    start = end
    while start >= 0 and names[start] == INGEST:
        start -= 1
    if end < 0 or (start < 0 and rec['first'] > 0):
        return None  # no ingest, or the ring may have dropped its start
    return Requests(rec, roots[start + 1:end + 1])
