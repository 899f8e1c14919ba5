"""Synthetic corpora, frozen: a copy of ``synth_sift_like`` and
``synth_glove_like`` from the repository's ``benchmarks/datasets.py``, so that
later changes there cannot move this benchmark's data.  numpy only.

``synth_sift_like``: 128-d, non-negative, integer-valued, low intrinsic
dimension, power-law clusters, clipped like SIFT descriptors.
``synth_glove_like``: dense cosine embeddings with power-law cluster sizes,
anisotropic spread and varying norms (``d`` wide).  Queries are held-out
draws from the same process.
"""
import numpy as np


def synth_sift_like(n: int, n_queries: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    d, d_int = 128, 20
    basis = rng.standard_normal((d_int, d)).astype(np.float32)
    n_coarse = 1024
    coarse = rng.standard_normal((n_coarse, d_int)).astype(np.float32) * 2.0
    w = rng.pareto(1.5, n_coarse) + 1e-3
    w /= w.sum()

    def draw(m, rs):
        cid = rs.choice(n_coarse, size=m, p=w)
        z = coarse[cid] + rs.standard_normal((m, d_int)).astype(np.float32) * 0.7
        x = z @ basis + rs.standard_normal((m, d)).astype(np.float32) * 0.35
        x = np.abs(x)
        nrm = np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
        x = x / nrm * 512.0
        np.clip(x, 0, 255, out=x)
        return np.floor(x).astype(np.float32)

    xb = np.empty((n, d), np.float32)
    for s in range(0, n, 200_000):
        e = min(s + 200_000, n)
        xb[s:e] = draw(e - s, np.random.default_rng(seed + 1 + s))
    xq = draw(n_queries, np.random.default_rng(seed + 999_999))
    return xb, xq


def synth_glove_like(n: int, n_queries: int, seed: int = 0, d: int = 200):
    rng = np.random.default_rng(seed)
    d_int = 32
    basis = rng.standard_normal((d_int, d)).astype(np.float32)
    n_coarse = 2048
    coarse = rng.standard_normal((n_coarse, d_int)).astype(np.float32) * 1.5
    w = rng.pareto(1.2, n_coarse) + 1e-3
    w /= w.sum()
    scales = (0.4 + rng.random(n_coarse).astype(np.float32)) * 0.8

    def draw(m, rs):
        cid = rs.choice(n_coarse, size=m, p=w)
        z = coarse[cid] + (
            rs.standard_normal((m, d_int)).astype(np.float32)
            * scales[cid][:, None]
        )
        x = z @ basis + rs.standard_normal((m, d)).astype(np.float32) * 0.25
        return x

    xb = np.empty((n, d), np.float32)
    for s in range(0, n, 200_000):
        e = min(s + 200_000, n)
        xb[s:e] = draw(e - s, np.random.default_rng(seed + 1 + s))
    xq = draw(n_queries, np.random.default_rng(seed + 999_999))
    return xb, xq


GENERATORS = {'synth_sift_like': synth_sift_like, 'synth_glove_like': synth_glove_like}
