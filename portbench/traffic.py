"""The one traffic generator: a mix file (``traffic/<mix>.json``) of
parameters turned into the requests of a closed loop.

Keys of a mix:
- ``call``: the ``AnnLite`` entry, ``search_numpy`` (a ``[batch, D]`` array
  in, distances and doc ids out) or ``search`` (query ``Doc`` objects in,
  matches attached), with ``include_metadata``;
- ``batch``: queries per request; ``limit``: the k of every request;
- ``pool``: queries each seed draws; request ``i`` takes the pool's next
  ``batch`` queries in order, cycling;
- ``filter``: null, or ``{"column", "op", "values"}``: each request filters
  ``{column: {op: value}}`` with a value drawn from ``values``; every run
  of ``len(values)`` requests takes each value once, in an order drawn from
  the seed, so every seed sends the same mix;
- ``warmup_requests``: requests sent before the window (set-up), from the
  middle of the pool, every filter value in turn;
- ``profile_requests``: requests the profiler covers in a traced run.
"""
from typing import Dict, Optional, Tuple

import numpy as np

CALLS = ('search_numpy', 'search')


class Traffic:
    def __init__(self, mix: Dict, seed: int):
        if mix['call'] not in CALLS:
            raise ValueError(f"unknown call {mix['call']!r}")
        self.call = mix['call']
        self.batch = int(mix['batch'])
        self.limit = int(mix['limit'])
        self.pool = int(mix['pool'])
        self.include_metadata = bool(mix.get('include_metadata', False))
        self.filter = mix.get('filter')
        self.values = list(self.filter['values']) if self.filter else [None]
        self._rng = np.random.default_rng([seed, 0x7AF1C])
        self._order: list = []

    def filter_dict(self, value) -> Optional[Dict]:
        if value is None:
            return None
        return {self.filter['column']: {self.filter['op']: value}}

    def _rows(self, start: int) -> np.ndarray:
        return (start + np.arange(self.batch)) % self.pool

    def request(self, i: int) -> Tuple[np.ndarray, object]:
        """Pool rows and filter value of window request ``i`` (requests are
        asked for in order)."""
        while len(self._order) <= i:
            self._order.extend(self._rng.permutation(len(self.values)).tolist())
        return self._rows(i * self.batch), self.values[self._order[i]]

    def warmup(self, i: int) -> Tuple[np.ndarray, object]:
        return self._rows(self.pool // 2 + i * self.batch), self.values[i % len(self.values)]
