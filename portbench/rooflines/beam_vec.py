"""``beam_vec``, the graph's vector traversal in one launch
(`annlite_torch/csrc/beam_vec.cu` on `csrc/beam.cuh`): one CTA walks one
query's whole beam search.

The bytes and operations of one launch, from its shape alone: ``n_queries``
queries, the list width ``ef``, rows of ``dim`` elements of ``row_bytes``
each, a predicate of ``mask_bytes`` a row (1 in a filtered search, else 0)
and ``limit`` results a query.  How far a search walks depends on the data
(the nodes it expands, the rows their W-wide adjacency rows name, how often
a row is named again), so none of that is counted: only what every search
of this shape needs.  Its list ends holding ``ef`` distinct scored rows, so
each query reads at least its query row (float32), those ``ef`` rows once,
each one's predicate byte and the 4-byte id (an adjacency entry or an entry
id) that named it, and writes ``limit`` results of a float32 distance and an
int32 id; each listed row costs ``dim`` multiply-adds.  The count neither
grows with iterations nor shrinks with a walk that reads less, so no change
of how the kernel walks moves it; what the kernel reads beyond it is what
its share of the roofline leaves.  The time the card needs at least is the
larger of the bytes at the HBM rate and the operations at the float32 rate
(NVIDIA H100 SXM data sheet, 700 W).
"""
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL = 'beam_vec_kernel'  # one launch per vector graph search


def bytes_ops(n_queries: int, ef: int, dim: int, row_bytes: int, mask_bytes: int,
              limit: int):
    per_query = 4 * dim + ef * (dim * row_bytes + mask_bytes + 4) + 8 * limit
    return n_queries * per_query, 2.0 * n_queries * ef * dim


def bound_s(n_queries: int, ef: int, dim: int, row_bytes: int, mask_bytes: int,
            limit: int) -> float:
    nbytes, ops = bytes_ops(n_queries, ef, dim, row_bytes, mask_bytes, limit)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
