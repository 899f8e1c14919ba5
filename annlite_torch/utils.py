"""Evaluation + data-generation helpers; the port's copy of
`annlite_tpu/utils.py` (reference `annlite/utils.py:16-71`), over the
port's own ``Doc``."""
from typing import Dict, List, Optional, Sequence

import numpy as np

from .doc import Doc


def precision(predicted: Sequence, relevant: Sequence, eval_at: Optional[int]) -> float:
    """Fraction of predicted (up to eval_at) that are relevant."""
    if eval_at == 0:
        return 0.0
    pred = list(predicted)[:eval_at] if eval_at is not None else list(predicted)
    n = len(pred)
    if n == 0:
        return 0.0
    return len(set(pred) & set(relevant)) / n


def recall(predicted: Sequence, relevant: Sequence, eval_at: Optional[int]) -> float:
    """Fraction of relevant found among predicted (up to eval_at)."""
    if eval_at == 0 or len(relevant) == 0:
        return 0.0
    pred = list(predicted)[:eval_at] if eval_at is not None else list(predicted)
    return len(set(pred) & set(relevant)) / len(relevant)


def evaluate(
    predicts: List[List[str]], relevants: List[List[str]], eval_at: Optional[int] = None
) -> Dict[str, float]:
    """Mean precision/recall over queries."""
    ps, rs = [], []
    for p, r in zip(predicts, relevants):
        ps.append(precision(p, r, eval_at))
        rs.append(recall(p, r, eval_at))
    return {'precision': float(np.mean(ps)), 'recall': float(np.mean(rs))}


def recall_at_k(
    predicted_idx: np.ndarray, groundtruth_idx: np.ndarray, k: int
) -> float:
    """Standard ANN benchmark recall@k over index matrices [Q, >=k]."""
    q = predicted_idx.shape[0]
    return float(
        np.mean(
            [
                len(set(predicted_idx[i, :k].tolist()) & set(groundtruth_idx[i, :k].tolist())) / k
                for i in range(q)
            ]
        )
    )


def docs_with_tags(
    n: int,
    n_dim: int,
    rng: Optional[np.random.Generator] = None,
    categories: Sequence[str] = ('comic', 'movie', 'audiobook'),
) -> List[Doc]:
    """Random corpus with filterable tags (reference `utils.py:44-71`)."""
    rng = rng or np.random.default_rng(0)
    x = rng.standard_normal((n, n_dim)).astype(np.float32)
    return [
        Doc(
            id=f'doc{i}',
            embedding=x[i],
            tags={
                'price': float(rng.uniform(0, 100)),
                'category': str(rng.choice(list(categories))),
            },
        )
        for i in range(n)
    ]
