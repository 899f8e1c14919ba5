"""Host spans around the program's layers, recorded from the benchmark's own
files in traced runs only.

Every attribute path the harness wraps sits in :data:`SPANS` and
:data:`ENTRIES`, relative to the ``AnnLite`` object.  A wrapper replaces the
bound method on its instance, so the program's own calls go through it; a
later change can point a layer at spans inside the program instead by
editing this table alone.  ``index.search`` returns numpy arrays, so its span
includes the wait for the card.
"""
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Callable, Dict, List, Tuple

# (layer, attribute path from the AnnLite object)
SPANS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ('filter', ('_container', '_build_mask')),
    ('storage', ('_container', 'cell_table', 'get_docids_by_rows')),
    ('storage', ('_container', 'doc_store', 'get')),
    ('index', ('_container', 'index', 'search')),
)
# the entry of each call a traffic mix can make; its layer's self time is
# the entry span minus the spans above
ENTRY_LAYER = 'facade'
ENTRIES: Dict[str, Tuple[str, ...]] = {
    'search_numpy': ('search_numpy',),
    'search': ('search',),
}
LAYERS = (ENTRY_LAYER,) + tuple(dict.fromkeys(layer for layer, _ in SPANS))


class Recorder:
    """Seconds per layer for each request; ``annotate`` also marks each span
    in the profiler's trace (``portbench.<layer>``)."""

    def __init__(self):
        self.requests: List[Dict[str, float]] = []
        self.annotate = False
        self._current = None

    def begin(self):
        self._current = defaultdict(float)

    def end(self) -> Dict[str, float]:
        cur, self._current = dict(self._current), None
        self.requests.append(cur)
        return cur

    def wrap(self, layer: str, fn: Callable) -> Callable:
        def span(*args, **kwargs):
            t = time.perf_counter()
            ctx = nullcontext()
            if self.annotate:
                from torch.profiler import record_function
                ctx = record_function(f'portbench.{layer}')
            try:
                with ctx:
                    return fn(*args, **kwargs)
            finally:
                if self._current is not None:
                    self._current[layer] += time.perf_counter() - t
        return span


def _owner(obj, path: Tuple[str, ...]):
    for name in path[:-1]:
        obj = getattr(obj, name)
    return obj


def install(ann, call: str, rec: Recorder) -> Callable:
    """Wrap the layers of ``ann`` and the entry ``call``; returns the wrapped
    entry.  Self time of the entry layer is what its span leaves to the
    others (see :func:`self_times`)."""
    for layer, path in SPANS:
        owner = _owner(ann, path)
        setattr(owner, path[-1], rec.wrap(layer, getattr(owner, path[-1])))
    path = ENTRIES[call]
    return rec.wrap(ENTRY_LAYER, getattr(_owner(ann, path), path[-1]))


def self_times(spans: Dict[str, float]) -> Dict[str, float]:
    """Per-layer seconds of one request, the entry's as its self time."""
    out = {layer: spans.get(layer, 0.0) for layer in LAYERS}
    out[ENTRY_LAYER] -= sum(out[layer] for layer in LAYERS if layer != ENTRY_LAYER)
    return out
