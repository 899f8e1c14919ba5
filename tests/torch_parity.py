"""Comparison helper shared by the tests that hold annlite_torch against
annlite_tpu."""
import numpy as np


def assert_topk_close(td, ti, jd, ji, gap=1e-5):
    """Distances at rtol 1e-5; ids equal wherever the neighbouring distances
    differ by more than ``gap`` (the order of near-ties may differ)."""
    td, ti, jd, ji = map(np.asarray, (td, ti, jd, ji))
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    for r in range(td.shape[0]):
        padded = np.concatenate([[-np.inf], jd[r], [np.inf]])
        for c in range(td.shape[1]):
            if padded[c + 1] - padded[c] > gap and padded[c + 2] - padded[c + 1] > gap:
                assert ti[r, c] == ji[r, c], (r, c, ti[r], ji[r])
