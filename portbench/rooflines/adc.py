"""K4, the PQ linear scan's deep select (`annlite_torch/csrc/adc.cu`, the
lookup core with the ``adc_block_top2`` epilogue, its table interleave and,
where the plan splits a block's groups, ``adc_merge``; then
``lane8_merge``, `csrc/fused_scan.cu`): ``n_queries`` queries' ADC tables
of ``m`` subspaces of ``k`` codewords against the codes of ``n_rows`` rows,
``code_bytes`` a code, to 1,024 candidates a query.

The bytes and operations of one search, from its shape alone, counting the
work and not a design: the bytes any implementation must move (each code
byte once, each query's float32 table once, and the 1,024 candidates a
query written as a float32 score and an int32 row) and the
``n_queries * n_rows * m`` table additions, at the card's fastest rate of
additions outside the tensor cores: two 16-bit additions a lane a clock
(the form of the repository's K9, `csrc/adc_i8.cu`), 132 SMs x 128 lanes x
2 x 1.98 GHz.  The rows are those the index holds, not the kernel's padded
blocks.  No later kernel that computes the same candidates can then take
less than the larger of the two, so its share cannot pass 100%.  The HBM
rate is the NVIDIA H100 SXM data sheet's, at 700 W.
"""
HBM_BYTES_PER_S = 3.35e12
ADDS_PER_S = 132 * 128 * 2 * 1.98e9
CANDIDATES = 1024
KERNELS = ('adc_kernel', 'interleave_kernel', 'adc_merge_kernel', 'lane8_merge_kernel')
LAUNCH = 'adc_kernel'  # one launch of the lookup core a search


def bytes_ops(n_queries: int, n_rows: int, m: int, k: int, code_bytes: int = 1):
    nbytes = (n_rows * m * code_bytes + n_queries * m * k * 4
              + n_queries * CANDIDATES * 8)
    return nbytes, float(n_queries) * n_rows * m


def bound_s(n_queries: int, n_rows: int, m: int, k: int, code_bytes: int = 1) -> float:
    nbytes, adds = bytes_ops(n_queries, n_rows, m, k, code_bytes)
    return max(nbytes / HBM_BYTES_PER_S, adds / ADDS_PER_S)
