"""The plain reference of the PQ linear scan with an exact rerank: what
``AnnLite(index_type='pq_scan', n_subvectors=M, rerank=R)`` answers under
the euclidean metric, in plain PyTorch, float64, in blocks, on whatever
device it is given.  It imports nothing of the program and takes the
codec's codebooks ``[M, K, ds]`` as given.

- :func:`encode`: each row's nearest codeword in each subspace by the
  float64 squared L2, ties to the lower index;
- :func:`tables`: each query's ADC table ``[M, K]``, ``(q - c)^2`` in
  float64;
- :func:`adc_scores`: every row's ADC score, the float64 sum of its
  entries;
- :func:`search`: the ``rerank`` lowest scores by a stable sort (ties to
  the lower row), each rescored exactly in float64 from the rows, and the
  ``limit`` nearest of them by a stable sort.

Where it departs from ``PQScanIndex`` (`annlite_torch/index/pq_scan.py`):

- The codec encodes in float32 through ``|x|^2 + |c|^2 - 2 x.c``; where two
  codewords lie within its rounding of each other it may take either. The
  reference decides exactly: :func:`code_ties` tells such rows apart.
- The program's tables and sums are float32 (summed over m in order
  0..M-1); the reference's are float64, so scores that differ by less than
  float32's rounding may order otherwise at the edge of the shortlist.
- On the card the shortlist comes from the deep select (K4 and
  ``lane8_merge``): the top 2 of each of 256 buckets in each block of 4,096
  rows, then the top 8 of each of 128 lane classes, 1,024 candidates a
  query, of which the ``rerank`` lowest are kept. The reference keeps the
  exact ``rerank`` lowest scores.
- The program reranks bfloat16 copies of the rows in float32; the reference
  reranks the rows in float64. Rows of integers up to 255 are exact in
  bfloat16 and their float32 sums are exact, so both give the same
  distances there.
- Euclidean only (the squared L2 distance, as the program reports it); no
  filter.
"""
from typing import Dict

import torch

ENCODE_BLOCK = 4096
QUERY_BLOCK = 64


def no_tf32():
    """float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """``[n, D] -> [n, M, ds]`` in float64."""
    return x.double().reshape(x.shape[0], m, -1)


def _sub_dist(xs: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """``xs [n, M, ds]`` against ``cb [M, K, ds]`` -> ``[n, M, K]`` squared
    L2 in float64, one dimension of the subspace at a time."""
    d = torch.zeros((xs.shape[0],) + cb.shape[:2], dtype=torch.float64, device=xs.device)
    for j in range(cb.shape[2]):
        d += (xs[:, :, None, j] - cb[None, :, :, j]) ** 2
    return d


def encode(x: torch.Tensor, codebooks: torch.Tensor, block: int = ENCODE_BLOCK) -> torch.Tensor:
    """Codes ``[n, M]`` int64: each subspace's nearest codeword, ties to the
    lower index."""
    cb = codebooks.double().to(x.device)
    out = torch.empty((x.shape[0], cb.shape[0]), dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        out[s:s + block] = torch.argmin(_sub_dist(_split(x[s:s + block], cb.shape[0]), cb), dim=2)
    return out


def code_ties(x: torch.Tensor, codebooks: torch.Tensor, codes: torch.Tensor,
              block: int = ENCODE_BLOCK) -> Dict[str, torch.Tensor]:
    """Where ``codes [n, M]`` differ from :func:`encode`'s: ``rows``,
    ``subspaces``, and ``gap``, how much farther (float64 squared L2) the
    given codeword lies than the nearest, with ``scale``, ``|x_m|^2 +
    |c|^2`` of the given one (the size a float32 computation rounds at)."""
    cb = codebooks.double().to(x.device)
    codes = codes.to(x.device).long()
    found = {'rows': [], 'subspaces': [], 'gap': [], 'scale': []}
    for s in range(0, x.shape[0], block):
        xs = _split(x[s:s + block], cb.shape[0])
        d = _sub_dist(xs, cb)
        best = torch.argmin(d, dim=2)
        given = codes[s:s + block]
        r, m = torch.nonzero(best != given, as_tuple=True)
        if r.numel() == 0:
            continue
        c = cb[m, given[r, m]]
        found['rows'].append(r + s)
        found['subspaces'].append(m)
        found['gap'].append(d[r, m, given[r, m]] - d[r, m, best[r, m]])
        found['scale'].append(torch.sum(xs[r, m] ** 2, dim=1) + torch.sum(c * c, dim=1))
    return {k: (torch.cat(v) if v else torch.zeros(0, device=x.device)) for k, v in found.items()}


def tables(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """ADC tables ``[Q, M, K]`` in float64."""
    cb = codebooks.double().to(q.device)
    return _sub_dist(_split(q, cb.shape[0]), cb)


def adc_scores(tab: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``tab [Q, M, K]`` and ``codes [N, M]`` -> float64 ``[Q, N]``."""
    codes = codes.to(tab.device).long()
    acc = torch.zeros((tab.shape[0], codes.shape[0]), dtype=torch.float64, device=tab.device)
    for m in range(tab.shape[1]):
        acc += tab[:, m, codes[:, m]]
    return acc


def search(q: torch.Tensor, x: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor,
           rerank: int, limit: int, block: int = QUERY_BLOCK) -> Dict[str, torch.Tensor]:
    """The scan with its rerank for queries ``q [Q, D]`` over rows ``x [N,
    D]`` with codes ``codes [N, M]``: ``shortlist [Q, rerank]`` (rows by
    ascending ADC score), ``ids [Q, limit]`` and their float64 squared L2
    ``dists``, ascending."""
    x = x.to(q.device)
    codes = codes.to(q.device)
    r = min(rerank, x.shape[0])
    out = {'shortlist': [], 'ids': [], 'dists': []}
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block].double()
        sc = adc_scores(tables(qb, codebooks), codes)
        short = torch.sort(sc, dim=1, stable=True)[1][:, :r]
        d = torch.sum((qb[:, None, :] - x[short].double()) ** 2, dim=2)
        d, pos = torch.sort(d, dim=1, stable=True)
        out['shortlist'].append(short)
        out['ids'].append(torch.gather(short, 1, pos[:, :limit]))
        out['dists'].append(d[:, :limit])
    return {k: torch.cat(v) for k, v in out.items()}
