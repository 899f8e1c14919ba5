"""The comparison that decides ``correct``: every answer of the window held
against the plain reference (`reference.py`).

For each query answered, the returned doc ids must be corpus docs
(``str(row)`` of the generated corpus), distinct, at most ``limit`` and not
fewer than the rows the filter passes allow, ordered by distance, inside
the request's filter, and, where the call returns metadata, carry the
generated tags.  Each returned distance is held to the float64 distance of
that query and that doc (``dist_err``: the largest gap over the window,
relative to ``|q|^2 + |x|^2``).  A request fails on any of these, or when it
raised.  ``recall_at_10`` is the mean share of each answer's distinct docs
that lie within the reference's exact ``limit``-th distance among the rows
inside that request's filter.
"""
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference import exact_topk, pair_dist64

OPS = {'$lt': np.less, '$lte': np.less_equal, '$gt': np.greater,
       '$gte': np.greater_equal, '$eq': np.equal, '$ne': np.not_equal}
PAIR_CHUNK = 1 << 16
# a returned doc at the reference's k-th distance counts as a hit: equal
# float64 distances (exact ties of integer-valued rows) are both right
TIE = 1e-9


def _parse(doc_id, n: int) -> int:
    """Corpus row of a doc id, -2 for an id the corpus does not hold."""
    if isinstance(doc_id, str) and doc_id.isdigit():
        r = int(doc_id)
        if r < n:
            return r
    return -2


def answers(records: Sequence[Dict], n: int, k: int, tag: Optional[str]):
    """Flatten the window's records into per-query arrays."""
    pool, val, req = [], [], []
    ids, dists, tags, nret = [], [], [], []
    for ri, r in enumerate(records):
        if r['error'] is not None:
            continue
        for j, row in enumerate(r['rows']):
            got_ids = list(r['ids'][j])
            got_d = np.asarray(r['dists'][j], dtype=np.float64).reshape(-1)
            m = len(got_ids)
            nret.append(m)
            pool.append(int(row))
            val.append(r['value_index'])
            req.append(ri)
            a = np.full(k, -1, np.int64)
            dd = np.full(k, np.nan)
            tt = np.full(k, np.nan)
            w = min(m, k)
            a[:w] = [_parse(x, n) for x in got_ids[:w]]
            dd[:min(w, len(got_d))] = got_d[:w]
            if tag is not None:
                tv = r['tags'][j] if r.get('tags') is not None else [None] * m
                tt[:w] = [t if isinstance(t, float) else np.nan for t in tv[:w]]
            ids.append(a)
            dists.append(dd)
            tags.append(tt)
    if not pool:
        z = np.zeros((0, k))
        return (np.zeros(0, np.int64),) * 3 + (z.astype(np.int64), z, z, np.zeros(0, np.int64))
    return (np.asarray(pool), np.asarray(val), np.asarray(req), np.stack(ids),
            np.stack(dists), np.stack(tags), np.asarray(nret))


def judge(records: Sequence[Dict], xb: torch.Tensor, xq: torch.Tensor, metric: str,
          k: int, column: Optional[np.ndarray], flt: Optional[Dict], values: List,
          tag: Optional[str], limits: Dict[str, float], reference_answers=None) -> Dict:
    """Hold the window's answers to the reference; ``reference_answers``
    (``exact_topk``'s output) may be passed when already computed."""
    dev = xb.device
    n = xb.shape[0]
    pool, val, req, ids, d, tg, nret = answers(records, n, k, tag)
    # the filter of each value as the reference applies it to the generated tags
    masks, counts = {}, {}
    for vi, v in enumerate(values):
        if v is None:
            masks[vi], counts[vi] = None, n
        else:
            m = OPS[flt['op']](column, v)
            masks[vi], counts[vi] = torch.from_numpy(m), int(m.sum())
    if reference_answers is None:
        reference_answers = exact_topk(xq, xb, metric, k, masks)
    a = len(pool)
    valid = ids >= 0
    foreign = (ids == -2).any(1)
    srt = np.sort(np.where(valid, ids, -1 - np.arange(k)[None, :]), axis=1)
    dup_pos = np.zeros_like(valid)
    # a later copy of a doc id already returned
    for j in range(k):
        dup_pos[:, j] = valid[:, j] & (ids[:, :j] == ids[:, j:j + 1]).any(1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    want = np.asarray([min(k, counts[v]) for v in val], np.int64) if a else np.zeros(0, np.int64)
    short = nret < want
    long_ = nret > k
    dd = np.where(np.isnan(d), np.inf, d)
    with np.errstate(invalid='ignore'):  # inf - inf past the last match
        unsorted = (np.diff(dd, axis=1) < 0).any(1) if k > 1 else np.zeros(a, bool)
    outside = np.zeros(a, bool)
    tag_bad = np.zeros(a, bool)
    if flt is not None:
        vcol = np.where(valid, column[np.clip(ids, 0, n - 1)], np.nan)
        vv = np.asarray([values[v] for v in val], dtype=np.float64)
        inside = OPS[flt['op']](vcol, vv[:, None])
        outside = (valid & ~inside).any(1)
        if tag is not None:
            tag_bad = (valid & ~(tg == vcol)).any(1)
    # float64 distance of every returned pair
    d64 = np.full(ids.shape, np.nan)
    sc = np.ones(ids.shape)
    pi, pj = np.nonzero(valid)
    for s in range(0, len(pi), PAIR_CHUNK):
        i_, j_ = pi[s:s + PAIR_CHUNK], pj[s:s + PAIR_CHUNK]
        qv = xq[torch.from_numpy(pool[i_]).to(dev)]
        xv = xb[torch.from_numpy(ids[i_, j_]).to(dev)]
        dp, sp = pair_dist64(qv, xv, metric)
        d64[i_, j_] = dp.cpu().numpy()
        sc[i_, j_] = sp.cpu().numpy()
    err = np.where(valid, np.abs(np.nan_to_num(d, nan=np.inf) - d64) / sc, 0.0)
    err_row = err.max(1) if a else np.zeros(0)
    dist_err = float(err_row.max()) if a else 0.0
    # recall against the reference's k-th distance inside the same filter
    kth = np.empty(a)
    for vi in set(val.tolist()):
        sel = val == vi
        ref_d = reference_answers[vi][1]
        kth[sel] = ref_d[torch.from_numpy(pool[sel]).to(ref_d.device), k - 1].cpu().numpy()
    hit = valid & ~dup_pos & (d64 <= kth[:, None] + TIE * sc)
    recall = hit.sum(1) / float(k)
    bad = foreign | dup | short | long_ | unsorted | outside | tag_bad | (err_row > limits['dist_err'])
    failed_req = {int(r) for r in req[bad]} | {i for i, r in enumerate(records) if r['error'] is not None}
    out = {
        'attempted': len(records),
        'failed': len(failed_req),
        'answered': int(a),
        'recall_at_10': float(recall.mean()) if a else math.nan,
        'dist_err': dist_err,
        'faults': {'raised': sum(r['error'] is not None for r in records),
                   'foreign_id': int(foreign.sum()), 'duplicate_id': int(dup.sum()),
                   'short': int(short.sum()), 'long': int(long_.sum()),
                   'unsorted': int(unsorted.sum()), 'outside_filter': int(outside.sum()),
                   'wrong_tags': int(tag_bad.sum()),
                   'dist_over_limit': int((err_row > limits['dist_err']).sum())},
    }
    out['checks'] = checks(out, limits)
    out['correct'] = all(c['ok'] for c in out['checks'].values())
    return out


def checks(res: Dict, limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number compared beside its limit."""
    rec = res['recall_at_10']
    return {
        'failed_requests': {'value': res['failed'], 'limit': 0, 'ok': res['failed'] == 0},
        'dist_err': {'value': res['dist_err'], 'limit': limits['dist_err'],
                     'ok': res['dist_err'] <= limits['dist_err']},
        'recall_at_10': {'value': rec, 'limit': limits['recall_at_10'],
                         'ok': not math.isnan(rec) and rec >= limits['recall_at_10']},
    }
