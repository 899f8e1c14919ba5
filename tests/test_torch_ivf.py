"""annlite_torch.ops.ivf against annlite_tpu.ops.ivf on identical numpy
inputs (the JAX functions through their CPU references, the port through
the kernels' plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch.index.ivf_pq import _dedup_candidates as t_dedup
from annlite_torch.ops import fused_scan as tfs
from annlite_torch.ops import ivf as tivf
from annlite_tpu.index.ivf_pq import _dedup_candidates as j_dedup
from annlite_tpu.ops import ivf as jivf
from torch_parity import assert_topk_close

BIG = 3.4e38
M, BS = 8, 128


def _append_all(stores, codes, cells, rows):
    for s in stores:
        s.append(codes, cells, rows)


def _stores(code_dtype=np.uint8, k=16, n=1500, n_cells=6, multi=False, seed=0,
            bs=BS):
    """The same appends and deletes on a JAX and a port ``BlockedCodes``."""
    rng = np.random.default_rng(seed)
    j = jivf.BlockedCodes(M, bs, code_dtype=code_dtype)
    t = tivf.BlockedCodes(M, bs, code_dtype=code_dtype, device='cpu')
    codes = rng.integers(0, k, (n, M)).astype(code_dtype)
    cells = rng.integers(0, n_cells, n)
    if multi:
        for s in (j, t):
            s.multi = True
        second = np.where(rng.random(n) < 0.3, rng.integers(0, n_cells, n), -1)
        both = np.stack([cells, second], axis=1)
        keep = both >= 0
        rep = np.nonzero(keep)[0]
        _append_all((j, t), codes[rep[:700]], both[keep][:700], rep[:700])
        _append_all((j, t), codes[rep[700:]], both[keep][700:], rep[700:])
    else:
        _append_all((j, t), codes[:900], cells[:900], np.arange(900))
        _append_all((j, t), codes[900:], cells[900:], np.arange(900, n))
    return j, t, codes, cells


def _same_store(j, t):
    for name in ('codes', 'mask', 'row_map', 'block_cell'):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t._cell_tail == j._cell_tail
    assert t._row_addr == j._row_addr
    assert t.multi == j.multi
    for ta, ja in zip(t.device_arrays(), j.device_arrays()):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize('multi', [False, True])
@pytest.mark.parametrize('code_dtype,k', [(np.uint8, 16), (np.uint16, 300)])
def test_blocked_codes_equal_jax(code_dtype, k, multi):
    j, t, _, _ = _stores(code_dtype, k, multi=multi)
    _same_store(j, t)
    # a delete after a device sync goes into the cached device mask in place
    mb = t.device_arrays()[1]
    for s in (j, t):
        s.delete_rows([0, 5, 77, 1499, 99999])
    assert t.device_arrays()[1] is mb
    _same_store(j, t)
    np.testing.assert_array_equal(t.select_blocks([1, 4]), j.select_blocks([1, 4]))
    flt = np.random.default_rng(3).random(1500) < 0.5
    np.testing.assert_array_equal(t.set_filter_mask(flt), j.set_filter_mask(flt))


def test_blocked_codes_refuse_wider_codes():
    t = tivf.BlockedCodes(M, BS, device='cpu')
    with pytest.raises(ValueError, match='truncated'):
        t.append(np.zeros((3, M), np.uint16), np.zeros(3), np.arange(3))


def _sel(j, cells, pads=0):
    sel = j.select_blocks(cells)
    return np.concatenate([sel, np.full(pads, -1, np.int32)]).astype(np.int32)


@pytest.mark.parametrize('return_addr', [False, True])
@pytest.mark.parametrize('filtered', [False, True])
def test_ivf_scan_topk_equal_jax(filtered, return_addr):
    j, t, _, _ = _stores()
    for s in (j, t):
        s.delete_rows(np.arange(0, 1500, 7))
    rng = np.random.default_rng(4)
    dtable = rng.uniform(0, 10, (3, M, 16)).astype(np.float32)
    sel = _sel(j, [0, 2, 3], pads=2)
    jcb, jmb, jrm = j.device_arrays()
    tcb, tmb, trm = t.device_arrays()
    if filtered:
        pred = (rng.random(1500) < 0.5).astype(np.int8)
        jmb = jivf.slot_mask_device(jmb, jrm, jnp.asarray(pred))
        tmb = tivf.slot_mask_device(tmb, trm, torch.from_numpy(pred))
        np.testing.assert_array_equal(tmb.numpy(), np.asarray(jmb))
    want = jivf.ivf_scan_topk(jnp.asarray(sel), dtable, jcb, jmb, jrm, 25,
                              use_pallas=False, return_addr=return_addr)
    got = tivf.ivf_scan_topk(torch.from_numpy(sel), torch.from_numpy(dtable), tcb,
                             tmb, trm, 25, return_addr=return_addr)
    assert len(got) == len(want) == (4 if return_addr else 2)
    jd = np.asarray(want[0])
    assert_topk_close(got[0].numpy(), got[1].numpy(), jd, np.asarray(want[1]))
    if return_addr:
        # where the distance is not a near-tie, the address is the JAX one
        assert_topk_close(got[0].numpy(), got[2].numpy(), jd, np.asarray(want[2]))
        assert_topk_close(got[0].numpy(), got[3].numpy(), jd, np.asarray(want[3]))
        rows = t.row_map[got[2].numpy(), got[3].numpy()]
        np.testing.assert_array_equal(rows, got[1].numpy())


def _oracle_ivf_select8(scores, sel, mask_blocks):
    """numpy oracle of the IVF deep select from the JAX reference's
    ``[Q, S, BS]`` scores: the kernel adds BIG per masked slot and per pad
    selection, so a masked slot of a pad selection sums to inf."""
    q, s, bs = scores.shape
    masked = mask_blocks[np.maximum(sel, 0)] == 0
    pad = (sel < 0)[:, None]
    v = np.where(masked & pad, np.float32(np.inf), scores).astype(np.float32)
    groups = bs // 128
    s4 = v.reshape(q, s, groups, 128)
    order = np.argsort(s4, axis=2, kind='stable')
    g1 = order[:, :, 0, :]
    mn1 = np.take_along_axis(s4, g1[:, :, None, :], 2)[:, :, 0, :]
    if groups > 1:
        g2 = order[:, :, 1, :]
        mn2 = np.take_along_axis(s4, g2[:, :, None, :], 2)[:, :, 0, :]
    else:  # no second group: inf, its row clamped to the first's
        g2, mn2 = np.zeros_like(g1), np.full_like(mn1, np.inf)
    lane = np.arange(128)
    base = (np.arange(s) * bs)[None, :, None]
    sc = np.concatenate([mn1, mn2], -1).reshape(q, s * 256)
    rc = np.concatenate([base + g1 * 128 + lane, base + g2 * 128 + lane], -1).reshape(q, s * 256)
    s3, r3 = sc.reshape(q, 2 * s, 128), rc.reshape(q, 2 * s, 128)
    top = np.argsort(s3, axis=1, kind='stable')[:, :8]
    return (np.take_along_axis(s3, top, 1).reshape(q, 1024),
            np.take_along_axis(r3, top, 1).reshape(q, 1024))


@pytest.mark.parametrize('bs', [128, 512])
def test_deep_select_candidates_equal_oracle(bs):
    """The plain K6 block pass + lane8 merge against a numpy oracle from the
    JAX reference ``_ivf_scan_ref``; dyadic tables make the scores exact in
    any summation order, so rows and scores must be equal."""
    j, _, _, _ = _stores(n=2000 + 14 * bs, n_cells=3, bs=bs)
    j.delete_rows(np.arange(0, 4000, 5))
    rng = np.random.default_rng(5)
    dtable = (rng.integers(0, 128, (2, M, 16)) / 8.0).astype(np.float32)
    sel = _sel(j, [0, 1, 2], pads=3)
    sel[-1] = sel[0]  # a block selected twice
    assert len(sel) >= 16
    cb, mb, rm = (np.array(a) for a in j.device_arrays())
    ref = np.asarray(jivf._ivf_scan_ref(jnp.asarray(sel), dtable, cb, mb))
    want_s, want_r = _oracle_ivf_select8(ref, sel, mb)
    s, r = tivf._ivf_block_top2_ref(torch.from_numpy(sel), torch.from_numpy(dtable),
                                    torch.from_numpy(cb), torch.from_numpy(mb))
    s8, r8 = tfs._lane8_merge_ref(s, r)
    np.testing.assert_array_equal(r8.numpy(), want_r)
    np.testing.assert_array_equal(s8.numpy(), want_s)
    # through ivf_scan_topk: the best rows of the exact scan
    d, rows = tivf.ivf_scan_topk(torch.from_numpy(sel), torch.from_numpy(dtable),
                                 torch.from_numpy(cb), torch.from_numpy(mb),
                                 torch.from_numpy(rm), 10, deep=True)
    np.testing.assert_array_equal(d.numpy(), np.sort(ref.reshape(2, -1), axis=1)[:, :10])


def test_ivf_scores_ref_equal_jax_u16():
    j, t, _, _ = _stores(np.uint16, 300)
    rng = np.random.default_rng(6)
    dtable = rng.uniform(0, 10, (2, M, 300)).astype(np.float32)
    sel = _sel(j, [1, 5], pads=1)
    cb, mb, _ = t.device_arrays()
    got = tivf._ivf_scan_ref(torch.from_numpy(sel), torch.from_numpy(dtable), cb, mb)
    jcb, jmb, _ = j.device_arrays()
    want = jivf._ivf_scan_ref(jnp.asarray(sel), dtable, jcb, jmb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_ivf_kernel_wrappers_refuse_cpu_tensors():
    _, t, _, _ = _stores()
    cb, mb, _ = t.device_arrays()
    ids = torch.zeros(2, dtype=torch.int32)
    dt = torch.zeros((1, M, 16))
    with pytest.raises(ValueError, match='CUDA'):
        tivf.ivf_scores(ids, dt, cb)
    with pytest.raises(ValueError, match='CUDA'):
        tivf.ivf_block_top2(ids, dt, cb, mb)


def test_dedup_candidates_equal_jax():
    rng = np.random.default_rng(7)
    rows = rng.integers(-1, 40, (4, 60)).astype(np.int32)
    d = rng.permutation(4 * 60).reshape(4, 60).astype(np.float32) / 7.0
    jd, jr = j_dedup(jnp.asarray(d), jnp.asarray(rows))
    td, tr = t_dedup(torch.from_numpy(d), torch.from_numpy(rows))
    jd, jr = np.asarray(jd), np.asarray(jr)
    real = jd < BIG / 2
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tr.numpy()[real], jr[real])
    for r in range(4):  # each row's best occurrence survives, once
        keep = tr.numpy()[r][td.numpy()[r] < BIG / 2]
        assert len(set(keep)) == len(keep) and set(keep) == set(rows[r][rows[r] >= 0])
