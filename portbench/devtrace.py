"""The device's side of a traced run, from ``torch.profiler``'s own trace.

:func:`profile` runs a fixed count of requests under the profiler, each
inside a ``portbench.request`` annotation, and reduces the exported trace
(Chrome trace format) with :func:`summarize`: the traced window (first
request's start to the last one's end), the seconds in which an operation
ran on the card (the union of kernel, memcpy and memset intervals inside the
window), kernel launches, seconds per kernel name, and the idle gaps named
by the innermost ``portbench.<layer>`` span the host was in, split where
those spans start and end.
"""
import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
REQUEST = 'portbench.request'
TOP = 10


def profile(fn: Callable[[int], None], n: int, out_dir: Path, cuda: bool) -> Dict:
    """Run ``fn(0) .. fn(n - 1)`` under the profiler; the summary of its trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            with record_function(REQUEST):
                fn(i)
        if cuda:
            torch.cuda.synchronize()
    path = Path(out_dir) / 'trace.json'
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        path.unlink(missing_ok=True)
    return summarize(events, n)


def _union(intervals: List[tuple], lo: float, hi: float) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _label(t: float, spans: List[tuple], starts: List[float]) -> str:
    """The innermost harness span covering time ``t`` (``spans`` sorted by
    start: spans nest, so the covering one that starts last is innermost)."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        a, b, name = spans[i]
        if t <= b:
            name = name[len('portbench.'):]
            return 'facade' if name == 'request' else name
        if name == REQUEST:
            break
    return 'between requests'


def summarize(events: List[Dict], n_requests: int) -> Optional[Dict]:
    """Reduce a Chrome-format trace (times in microseconds) to seconds.
    None when the trace holds no request annotation."""
    spans, dev = [], []
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    launches = 0
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        cat = str(e.get('cat', '')).lower()
        a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
        name = str(e.get('name', ''))
        if cat == 'user_annotation' and name.startswith('portbench.'):
            spans.append((a, b, name))
        elif cat in DEVICE_CATS:
            dev.append((a, b))
            if cat == 'kernel':
                launches += 1
                kernel_n[name[:200]] += 1
            kernel_s[name[:200]] += (b - a) * 1e-6
    req = [(a, b) for a, b, name in spans if name == REQUEST]
    if not req:
        return None
    lo, hi = min(a for a, _ in req), max(b for _, b in req)
    busy = _union(dev, lo, hi)
    spans.sort()
    starts = [a for a, _, _ in spans]
    edges = sorted({t for a, b, _ in spans for t in (a, b)})
    gaps, prev = defaultdict(float), lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            # split the gap where a host span starts or ends
            cuts = edges[bisect.bisect_right(edges, prev):bisect.bisect_left(edges, a)]
            for x, y in zip([prev] + cuts, cuts + [a]):
                gaps[_label((x + y) / 2, spans, starts)] += (y - x) * 1e-6
        prev = max(prev, b)
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        'requests': n_requests,
        'window_s': (hi - lo) * 1e-6,
        'busy_s': sum(b - a for a, b in busy) * 1e-6,
        'launches': launches,
        'kernel_s': dict(kernel_s),
        'kernel_n': dict(kernel_n),
        'device_ops': [[k, v] for k, v in top],
        'idle_gaps': [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
