"""K1, the int8 flat scan: ``block_top2`` (with its ``split_merge`` where the
plan splits the rows) and ``lane8_merge`` (`annlite_torch/csrc/fused_scan.cu`).

The bytes and operations of one block pass over ``n_rows`` int8 rows of
``dim`` for ``n_queries`` queries, frozen from ``chip_smoke.py``'s
``bound()`` for ``block_top2``: each int8 row once, a float32 scale and a
float32 bias (the mask, and the norms for euclidean) a row, the int8 queries
and their scales, and the candidates written, top-2 of each of 256 buckets
in each block of 8,192 rows as a float32 score and an int32 row.  The time
the card needs at least is the larger of the bytes at the HBM rate and the
int8 products at the int8 tensor-core rate (NVIDIA H100 SXM data sheet,
dense, 700 W).
"""
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BLOCK_ROWS = 8192
KERNELS = ('block_top2_kernel', 'split_merge_kernel', 'lane8_merge_kernel')
LAUNCH = 'block_top2_kernel'  # one launch per K1 call


def bytes_ops(n_rows: int, dim: int, n_queries: int):
    n_blocks = -(-n_rows // BLOCK_ROWS)
    nbytes = (n_rows * dim + 8 * n_rows + n_queries * dim + 4 * n_queries
              + n_queries * n_blocks * 256 * 8)
    return nbytes, 2.0 * n_queries * n_rows * dim


def bound_s(n_rows: int, dim: int, n_queries: int) -> float:
    nbytes, ops = bytes_ops(n_rows, dim, n_queries)
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
