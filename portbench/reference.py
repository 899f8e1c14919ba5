"""The plain reference: brute-force nearest neighbours in plain PyTorch.

It reads only the inputs the harness generated (corpus, queries, tag
column) and nothing the program made.  The scan that ranks candidates runs
in float32 with TF32 off, in blocks of queries, on whatever device it is
given; every distance it reports is recomputed pair by pair in float64.

``precision`` makes the control: the same computation on inputs rounded to
a lower precision (``'tf32'``: 10 mantissa bits, what a TF32 tensor-core
product reads; ``'bf16'``; ``'fp8'``: float8 e4m3), with products summed in
float32 and the distances taken from that computation.  The benchmark's own
runs never use it.
"""
from typing import Dict, Hashable, Optional, Tuple

import torch

METRICS = ('cosine', 'euclidean')


def no_tf32():
    """float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision`` and returned as float32."""
    if precision is None:
        return x
    if precision == 'tf32':
        # round to nearest, ties to even, at 10 mantissa bits (13 dropped)
        b = x.contiguous().view(torch.int32)
        b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)
    if precision == 'bf16':
        return x.to(torch.bfloat16).float()
    if precision == 'fp8':
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f'unknown precision {precision!r}')


def prepare(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Rows as the metric compares them: unit rows for cosine (in float32)."""
    x = x.float()
    if metric == 'cosine':
        return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-30)
    return x


def pair_dist64(q: torch.Tensor, x: torch.Tensor, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distances of row pairs ``q[i]``, ``x[i]`` in float64, and the scale
    each is judged against (``|q|^2 + |x|^2`` of the rows as the metric sees
    them: 2 for cosine).  Cosine: ``1 - <q/|q|, x/|x|>``; euclidean: the
    squared L2 distance, as the program reports them."""
    q = q.double()
    x = x.double()
    if metric == 'cosine':
        q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-300)
        x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-300)
        d = 1.0 - torch.sum(q * x, dim=1)
    else:
        d = torch.sum((q - x) ** 2, dim=1)
    scale = torch.sum(q * q, dim=1) + torch.sum(x * x, dim=1)
    return d, scale


def _scores(q: torch.Tensor, xb: torch.Tensor, xb_sq: torch.Tensor, metric: str) -> torch.Tensor:
    """Rank scores ``[Q, N]`` in float32 (lower is nearer); ``q`` and ``xb``
    already prepared.  For euclidean the query's own norm is left out, so
    these are ranks, not distances."""
    dots = torch.matmul(q, xb.t())
    if metric == 'cosine':
        return -dots
    return xb_sq[None, :] - 2.0 * dots


def exact_topk(xq, xb, metric: str, k: int,
               masks: Optional[Dict[Hashable, Optional[torch.Tensor]]] = None,
               block: int = 512, precision: Optional[str] = None):
    """For each key of ``masks`` (``{None: None}`` by default: no filter),
    the ``k`` nearest rows of ``xb`` to every query of ``xq`` among the rows
    the mask passes: ``{key: (ids int64 [Q, k], dists [Q, k])}`` ordered by
    distance.  With ``precision`` None, ``dists`` are float64 pair distances
    and ids are ordered by them (the scan only picks ``k`` + 22 candidates);
    with a lower ``precision`` (the control), ids and float32 distances both
    come from the rounded computation.  Rows a mask rejects never appear;
    a mask passing fewer than ``k`` rows leaves -1 ids."""
    if metric not in METRICS:
        raise ValueError(f'unknown metric {metric!r}')
    masks = {None: None} if masks is None else masks
    dev = xb.device
    xq_p = round_to(prepare(xq, metric), precision)
    xb_p = round_to(prepare(xb, metric), precision)
    xb_sq = torch.sum(xb_p * xb_p, dim=1)
    n = xb.shape[0]
    depth = min(n, k if precision else k + 22)
    out = {key: ([], []) for key in masks}
    for s in range(0, xq.shape[0], block):
        qb = xq_p[s:s + block]
        sc = _scores(qb, xb_p, xb_sq, metric)
        for key, m in masks.items():
            scm = sc if m is None else sc.masked_fill(~m.to(dev)[None, :], float('inf'))
            v, ids = torch.topk(scm, depth, dim=1, largest=False, sorted=True)
            ids = torch.where(torch.isinf(v), -1, ids)
            if precision:
                qsq = torch.sum(qb * qb, dim=1)[:, None]
                d = (1.0 + v) if metric == 'cosine' else (v + qsq)
                out[key][0].append(ids[:, :k])
                out[key][1].append(d[:, :k])
                continue
            safe = ids.clamp_min(0)
            rows = torch.arange(qb.shape[0], device=dev)[:, None].expand_as(ids)
            d, _ = pair_dist64(xq[s:s + block][rows.reshape(-1)].to(dev),
                               xb[safe.reshape(-1)], metric)
            d = d.view(ids.shape).masked_fill(ids < 0, float('inf'))
            d, order = torch.sort(d, dim=1, stable=True)
            ids = torch.gather(ids, 1, order)
            out[key][0].append(ids[:, :k])
            out[key][1].append(d[:, :k])
    return {key: (torch.cat(i), torch.cat(d)) for key, (i, d) in out.items()}
