"""One run of one cell: set-up through ``AnnLite.index``, warm-up, a closed
loop of one client for the window, then the comparison with the reference.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, each
end-to-end metric's reader in ``endtoend/<name>.py`` and each per-layer
metric's in ``metrics/<name>.py`` (each a ``read(ctx)`` returning a number
or None), and each kernel's bytes and operations in ``rooflines/<kernel>.py``.

A configuration whose ``AnnLite`` arguments need a trained codec
(``n_subvectors``, ``n_cells > 1`` or ``n_components``) carries
``"train": {"sample": <int>}``: set-up then calls ``AnnLite.train`` once on
that many distinct corpus rows, drawn from the seed alone (:func:`train_rows`),
before the first ``AnnLite.index``, and times it as ``setup_split_s['train']``.
"""
import gc
import importlib.util
import json
import resource
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import compare, datasets, devtrace, reference, spans
from .traffic import Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PY_TYPES = {'float': float, 'int': int, 'str': str}
# the generator tag of the training sample: the rows depend on the seed alone
TRAIN_TAG = 0x7EA1


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f'portbench_{path.parent.name}_{path.stem}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, path: Path = ROOT / 'BENCHMARK.json', home: Path = HERE):
        self.spec = load_json(path)
        self.home = home

    def cell(self, name: str) -> Dict:
        for w in self.spec['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, cell: Dict) -> Dict:
        return load_json(self.home / 'configs' / f"{cell['config']}.json")

    def traffic(self, cell: Dict) -> Dict:
        return load_json(self.home / 'traffic' / f"{cell['traffic']}.json")

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.spec['end_to_end']
                if cell['name'] in m.get('workloads', [cell['name']])]

    def per_layer(self, cell: Dict) -> List[Dict]:
        e2e = {m['name'] for m in self.end_to_end(cell)}
        return [m for m in self.spec['per_layer']
                if (cell['name'] in m['workloads'] if 'workloads' in m else m['moves'] in e2e)]

    def reader(self, kind: str, name: str):
        return load_module(self.home / kind / f'{name}.py')

    def roofline(self, kernel: str):
        return load_module(self.home / 'rooflines' / f'{kernel}.py')


def check_train(config: Dict):
    """Refuse a configuration whose ``AnnLite`` has a codec to train before
    its first insert (a PQ codec, a VQ codec or a projector) and no
    ``train``, and a ``train`` that is not ``{"sample": <positive int>}``."""
    name = config.get('name', '?')
    train = config.get('train')
    if train is None:
        kw = config['annlite']
        if kw.get('n_subvectors') or kw.get('n_cells', 1) > 1 or kw.get('n_components'):
            raise ValueError(
                f"configuration {name!r}: its annlite arguments (n_subvectors, "
                f"n_cells > 1 or n_components) need a trained codec; give it a "
                f"'train' key, {{\"sample\": <rows>}}")
    elif not (isinstance(train, dict) and set(train) == {'sample'}
              and type(train['sample']) is int and train['sample'] > 0):
        raise ValueError(f"configuration {name!r}: 'train' must be "
                         f'{{"sample": <positive int>}}, got {train!r}')


def configure(bench: Bench, cell: Dict, overrides: Optional[Dict] = None):
    """The cell's configuration and traffic mix, with ``overrides``; the
    configuration's ``train`` key checked (:func:`check_train`)."""
    over = dict(overrides or {})
    mix = {**bench.traffic(cell), **over.pop('traffic', {})}
    config = {**bench.config(cell), **over}
    check_train(config)
    return config, mix


def train_rows(seed: int, n_docs: int, sample: int) -> np.ndarray:
    """The corpus rows the codecs train on: ``min(sample, n_docs)`` distinct
    rows, ascending, from a generator of the seed and the harness's own tag,
    whatever the traffic, the tags or the ingest batch."""
    rng = np.random.default_rng([seed, TRAIN_TAG])
    return np.sort(rng.choice(n_docs, size=min(sample, n_docs), replace=False))


def make_data(config: Dict, pool: int, seed: int):
    """Corpus ``[n_docs, n_dim]``, query pool and tag columns from the seed."""
    data = config['data']
    gen = datasets.GENERATORS[data['generator']]
    xb, xq = gen(config['n_docs'], pool, seed=seed, **data.get('kwargs', {}))
    cols = {}
    for i, (name, spec) in enumerate(sorted(config.get('tags', {}).items())):
        lo, hi = spec['uniform']
        cols[name] = np.random.default_rng([seed, 0x7A65, i]).uniform(lo, hi, config['n_docs'])
    return xb, xq, cols


def build(config: Dict, xb: np.ndarray, cols: Dict[str, np.ndarray], data_path: Path,
          device: str, seed: int):
    """The ``AnnLite`` of the configuration, made the way a user makes it:
    ``AnnLite.train`` on the sample of :func:`train_rows` where the
    configuration has ``train``, then ``AnnLite.index`` in requests of
    ``ingest_batch`` docs.  Returns it and the seconds training took (0
    without ``train``)."""
    from annlite_torch import AnnLite
    from annlite_torch.doc import Doc

    kw = dict(config['annlite'])
    if 'columns' in kw:
        kw['columns'] = [(c, PY_TYPES[t]) for c, t in kw['columns']]
    ann = AnnLite(data_path=str(data_path), device=device, **kw)
    train_s = 0.0
    if 'train' in config:
        t = time.perf_counter()
        ann.train(xb[train_rows(seed, xb.shape[0], config['train']['sample'])])
        train_s = time.perf_counter() - t
    step = int(config['ingest_batch'])
    names = sorted(cols)
    for lo in range(0, xb.shape[0], step):
        hi = min(lo + step, xb.shape[0])
        vals = {c: cols[c][lo:hi].tolist() for c in names}
        ann.index([Doc(id=str(r), embedding=xb[r],
                       tags={c: vals[c][r - lo] for c in names})
                   for r in range(lo, hi)])
    return ann, train_s


def make_call(ann, t: Traffic, entry: Optional[Callable] = None) -> Callable:
    """``call(queries, value)`` -> the record fields of one request."""
    if t.call == 'search_numpy':
        fn = entry or ann.search_numpy

        def call(q, value):
            dists, ids = fn(q, filter=t.filter_dict(value), limit=t.limit)
            return {'ids': ids, 'dists': dists}
        return call

    from annlite_torch.doc import Doc
    fn = entry or ann.search
    col = t.filter['column'] if t.filter and t.include_metadata else None

    def call(q, value):
        docs = [Doc(id=f'q{j}', embedding=q[j]) for j in range(q.shape[0])]
        fn(docs, filter=t.filter_dict(value), limit=t.limit,
           include_metadata=t.include_metadata)
        out = {'docs': docs}
        if col is not None:
            out['tag'] = col
        return out
    return call


def _compact(out: Dict) -> Dict:
    """A reply as tuples of str and float (and float arrays), taken as it
    arrives: kept records then hold nothing the cyclic collector walks, so
    the window's collections are the program's own."""
    if 'docs' in out:
        ms = [d.matches for d in out['docs']]
        rec = {'ids': tuple(tuple(m.id for m in x) for x in ms),
               'dists': tuple(tuple(float(m.score) for m in x) for x in ms)}
        if 'tag' in out:
            rec['tags'] = tuple(tuple(m.tags.get(out['tag']) for m in x) for x in ms)
        return rec
    return {'ids': tuple(tuple(r) for r in out['ids']),
            'dists': tuple(np.asarray(r, dtype=np.float64) for r in out['dists'])}


class Context:
    """What a per-layer reader reads: the traced run's host spans per request
    (the profiled requests left out), the device trace's summary, the cell,
    its configuration and traffic."""

    def __init__(self, bench, cell, config, mix, span_rows, latency_s, trace):
        self.bench, self.cell, self.config, self.mix = bench, cell, config, mix
        self.spans = span_rows
        self.latency_s = np.asarray(latency_s)
        self.trace = trace

    def layer_ms(self, layer: str) -> Optional[float]:
        """Mean self ms of ``layer`` per traced request."""
        if not self.spans:
            return None
        return 1e3 * float(np.mean([spans.self_times(r)[layer] for r in self.spans]))

    def device(self) -> Optional[Dict]:
        """The device trace, where an operation ran on the card."""
        if not self.trace or self.trace['busy_s'] <= 0:
            return None
        return self.trace

    def kernels(self, names) -> Tuple[float, Dict[str, int]]:
        """Seconds on the card of the kernels whose names contain one of
        ``names``, and the launches of each of ``names``."""
        tr = self.device()
        if tr is None:
            return 0.0, {n: 0 for n in names}
        sec = sum(v for k, v in tr['kernel_s'].items() if any(n in k for n in names))
        return sec, {n: sum(c for k, c in tr['kernel_n'].items() if n in k) for n in names}


def _records_of(raw) -> List[Dict]:
    out = []
    for rows, value_index, reply, err in raw:
        rec = {'rows': rows, 'value_index': value_index, 'error': err}
        if err is None:
            rec.update(reply)
        out.append(rec)
    return out


def _usage() -> Tuple[float, float, int, int]:
    """CPU seconds of the process and of this thread, and the process's
    voluntary and involuntary context switches, so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime, time.thread_time(), r.ru_nvcsw, r.ru_nivcsw


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', t_process: Optional[float] = None,
             overrides: Optional[Dict] = None, tamper: Optional[Callable] = None) -> Dict:
    """One run; returns the result object the CLI prints.  ``overrides``
    (configuration keys, and traffic keys under ``'traffic'``) and
    ``tamper`` (called with the built ``AnnLite``, to break the timed path
    underneath) serve the tests."""
    t0 = time.perf_counter() if t_process is None else t_process
    cell = bench.cell(cell_name)
    config, mix = configure(bench, cell, overrides)
    limits = config['limits']
    cuda = device == 'cuda'
    reference.no_tf32()
    t = Traffic(mix, seed)
    xb, xq, cols = make_data(config, t.pool, seed)
    t_data = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix='portbench-'))
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ann, train_s = build(config, xb, cols, tmp / 'store', device, seed)
        t_build = time.perf_counter()
        if tamper is not None:
            tamper(ann)
        rec = spans.Recorder()
        entry = spans.install(ann, t.call, rec) if trace else None
        call = make_call(ann, t, entry)
        for i in range(int(mix['warmup_requests'])):
            rows, value = t.warmup(i)
            call(xq[rows], value)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        raw, lat = [], []

        def one(i, record_spans):
            rows, value = t.request(i)
            if record_spans:
                rec.begin()
            s = time.perf_counter()
            try:
                reply, err = call(xq[rows], value), None
            except Exception:  # a lost request counts as failed, the loop goes on
                reply, err = None, traceback.format_exc(limit=4)
            lat.append(time.perf_counter() - s)
            if record_spans:
                rec.end()
            raw.append((rows, t.values.index(value), None if err else _compact(reply), err))

        u0 = _usage()
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while time.perf_counter() < deadline:
            one(i, trace)
            i += 1
        window_s = time.perf_counter() - start
        u1 = _usage()
        n_window = i
        dev_trace = None
        if trace:
            rec.annotate = True
            n_prof = int(mix['profile_requests'])
            dev_trace = devtrace.profile(lambda j: one(n_window + j, False), n_prof, tmp, cuda)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        ann.close()
        del ann, call, entry
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        records = _records_of(raw)
        dev = torch.device(device)
        col = cols[t.filter['column']] if t.filter else None
        res = compare.judge(records, torch.from_numpy(xb).to(dev), torch.from_numpy(xq).to(dev),
                            config['annlite']['metric'], t.limit, col, t.filter, t.values,
                            t.filter['column'] if (t.filter and t.include_metadata) else None,
                            limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    window = {
        'seconds': window_s, 'requests': n_window,
        'queries': n_window * t.batch, 'latency_s': lat[:n_window],
        'setup_s': setup_s, 'peak_bytes': peak, 'judge': res,
    }
    if trace:
        ctx = Context(bench, cell, config, mix, rec.requests, lat[:n_window], dev_trace)
        metrics = {}
        for m in bench.per_layer(cell):
            v = bench.reader('metrics', m['name']).read(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {}
        for m in bench.end_to_end(cell):
            v = bench.reader('endtoend', m['name']).read(window)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    out = {'correct': res['correct'], 'attempted': res['attempted'], 'failed': res['failed'],
           'metrics': metrics}
    if cuda:
        out['device'] = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                         'count': int(cell['chips']), 'memory_peak_bytes': int(peak)}
    else:
        out['device'] = {'platform': 'cpu', 'kind': 'cpu', 'count': 0, 'memory_peak_bytes': 0}
    if trace and dev_trace is not None:
        out['device'].update(busy_s=dev_trace['busy_s'], window_s=dev_trace['window_s'])
        out['breakdown'] = {'device_ops': dev_trace['device_ops'],
                            'idle_gaps': dev_trace['idle_gaps']}
    split = {'data': t_data - t0}
    if 'train' in config:
        split['train'] = train_s
    split.update(ingest=t_build - t_data - train_s, warmup=t0 + setup_s - t_build)
    # requests completed in each quarter of the window: drift within a run
    ends = np.cumsum(lat[:n_window])
    quarters = np.bincount(np.minimum((4 * ends / max(window_s, 1e-9)).astype(int), 3),
                           minlength=4).tolist()
    out['detail'] = {'window_s': window_s, 'requests': n_window, 'answered': res['answered'],
                     'requests_by_quarter': quarters,
                     'faults': res['faults'], 'setup_s': setup_s,
                     'setup_split_s': split,
                     # the window's host: CPU seconds of the process and of the
                     # request loop's thread, voluntary and involuntary switches
                     'window_usage': [b - a for a, b in zip(u0, u1)]}
    out['checks'] = {k: {'value': v['value'], 'limit': v['limit']} for k, v in res['checks'].items()}
    return out
