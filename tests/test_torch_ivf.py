"""annlite_torch.ops.ivf against annlite_tpu.ops.ivf on identical numpy
inputs (the JAX functions through their CPU references, the port through
the kernels' plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annlite_torch.index.ivf_pq import _dedup_candidates as t_dedup
from annlite_torch.ops import adc as tadc
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


QT = tadc.MAX_QUERY_TILE
TILE_EDGES = [1, QT - 1, QT, QT + 1, 2 * QT + 1]


@pytest.mark.parametrize('nq', TILE_EDGES)
def test_deep_select_candidates_equal_oracle_query_tiles(nq):
    """The plain K6 block pass + lane8 merge against the numpy oracle from
    the JAX reference at the query tile's edges (dyadic tables: exact), and
    the plain K7 scores bit-equal to the JAX reference's."""
    j, _, _, _ = _stores(n=2000 + 14 * 128, n_cells=3, bs=128)
    j.delete_rows(np.arange(0, 4000, 5))
    rng = np.random.default_rng(nq)
    dtable = (rng.integers(0, 128, (nq, M, 16)) / 8.0).astype(np.float32)
    sel = _sel(j, [0, 1, 2], pads=3)
    cb, mb, _ = (np.array(a) for a in j.device_arrays())
    ref = np.asarray(jivf._ivf_scan_ref(jnp.asarray(sel), dtable, cb, mb))
    want_s, want_r = _oracle_ivf_select8(ref, sel, mb)
    s, r = tivf._ivf_block_top2_ref(torch.from_numpy(sel), torch.from_numpy(dtable),
                                    torch.from_numpy(cb), torch.from_numpy(mb))
    s8, r8 = tfs._lane8_merge_ref(s, r)
    np.testing.assert_array_equal(r8.numpy(), want_r)
    np.testing.assert_array_equal(s8.numpy(), want_s)
    got = tivf._ivf_scan_ref(torch.from_numpy(sel), torch.from_numpy(dtable),
                             torch.from_numpy(cb), torch.from_numpy(mb))
    np.testing.assert_array_equal(got.numpy(), ref)


IVF_QUERIES = sorted(set(range(1, 34)) | set(TILE_EDGES))


def _check_ivf_plan_covers(n_sel, bs, m, k, queries):
    """For every batch in ``queries``: K7's plan and K6's own body
    (`ops/ivf.py` ``ivf_plan``, ``_top2_plan``) compute each (selection,
    group, lane, query) cell exactly once, within the kernels' limits; K6's
    grid fills the card, and its plan is its own body or the lookup core."""
    groups = bs // 128
    for nq in queries:
        k6 = tivf.ivf_plan('ivf_block_top2', nq, n_sel, bs, m, k)
        own = tivf._top2_plan(nq, n_sel, bs, m, k, tadc.TARGET_CTAS)
        assert k6 == own or (k6.kernel == 'core' and k6.core == tadc.adc_plan(nq, n_sel, bs, m, k))
        for plan in (tivf.ivf_plan('ivf_scores', nq, n_sel, bs, m, k), own):
            assert plan.smem <= tadc.MAX_SMEM
            if plan.kernel == 'core':  # held by _check_plan_covers
                assert nq > tivf.ROWS_MAX_QUERIES
                continue
            ctas = tivf.ivf_plan_ctas(plan, nq, n_sel, bs)
            assert len(ctas) == plan.grid
            seen = np.zeros((n_sel, groups, nq), np.int32)
            if plan.kernel == 'rows':
                assert nq <= tivf.ROWS_MAX_QUERIES and plan.threads * 2 == tivf.ROWS_PER_CTA
                for (sel, slots, qs), in ctas:
                    # 32 threads of 2 slots: a 64-slot half of one group
                    assert len(slots) == tivf.ROWS_PER_CTA and slots.start % 64 == 0
                    seen[sel, slots.start // 128, qs.start:qs.stop] += 1
                seen //= 2  # two CTAs a group
            else:
                assert plan.threads == tivf.TOP2_THREADS and plan.qt == min(nq, 2)
                assert plan.units == plan.tiles * n_sel * groups
                # one CTA per SM up to a remainder (within 10% at Q <= 33), or
                # one per unit where units are fewer
                assert plan.grid == plan.tiles * plan.cpt <= max(tadc.TARGET_CTAS, plan.tiles)
                if n_sel * groups >= tadc.TARGET_CTAS // plan.tiles:
                    assert plan.grid >= 0.9 * tadc.TARGET_CTAS
                assert all(ctas), 'a CTA without work'
                for units in ctas:
                    for sel, slots, qs in units:
                        # a warp's 32 threads of 4 lanes hold the group's 128 slots
                        assert len(slots) == 128 and slots.start % 128 == 0
                        seen[sel, slots.start // 128, qs.start:qs.stop] += 1
            assert (seen == 1).all(), (nq, plan)


@pytest.mark.parametrize('n_sel', [1, 2, 8, 15, 16, 17, 40, 118, 139, 140, 300])
def test_ivf_plan_covers_each_cell_once(n_sel):
    """K6/K7's plans over the chip run's selections of 1,024-slot blocks
    (probe sets padded with -1, and the IVF-PQ phase's 118-139 blocks):
    every (selection, group, slot lane, query) once, for Q = 1..130 on the
    lookup core's plan and Q = 1..33 on ``ivf_plan``'s."""
    from test_torch_adc import _check_plan_covers
    _check_plan_covers(n_sel, 1024, 64, 256, range(1, 131))
    _check_ivf_plan_covers(n_sel, 1024, 64, 256, IVF_QUERIES)


def test_ivf_plan_shapes():
    """The IVF-PQ phase's shapes: K6 at Q = 8, S = 139 one CTA on each of
    132 SMs with the tile's table resident (two queries a tile); K7 at Q = 1
    its own body of 16 one-warp CTAs, the lookup core above two queries; u16
    codes at K = 1024 read their tables through L2."""
    p6 = tivf.ivf_plan('ivf_block_top2', 8, 139, 1024, 64, 256)
    assert (p6.kernel, p6.qt, p6.tiles, p6.grid, p6.smem_tab) == ('top2', 2, 4, 132, True)
    assert p6.smem == 64 * 256 * 2 * 4 + 16 * 2 * 128 * 4 + 16
    assert tivf.ivf_plan('ivf_block_top2', 1, 16, 1024, 64, 256).qt == 1
    assert not tivf.ivf_plan('ivf_block_top2', 8, 139, 1024, 64, 1024).smem_tab
    # K6's body by its cost model, on both sides of the crossovers measured
    # on the card: few selections leave the core's grid short of the card
    for nq, n_sel, body in ((8, 139, 'top2'), (33, 139, 'top2'), (64, 139, 'core'),
                            (8, 256, 'core'), (17, 256, 'top2'), (64, 256, 'core')):
        assert tivf.ivf_plan('ivf_block_top2', nq, n_sel, 1024, 64, 256).kernel == body
    p7 = tivf.ivf_plan('ivf_scores', 1, 1, 1024, 64, 256)
    assert (p7.kernel, p7.grid, p7.threads) == ('rows', 16, 32)
    assert tivf.ivf_plan('ivf_scores', 2, 15, 1024, 64, 256).kernel == 'rows'
    assert tivf.ivf_plan('ivf_scores', 3, 15, 1024, 64, 256).kernel == 'core'
    assert p7.smem_tab and p7.smem == 65536 + 128  # the table, then its mbarriers
    assert not tivf.ivf_plan('ivf_scores', 1, 1, 1024, 64, 1024).smem_tab  # 256 KB: L2
    assert tivf.ivf_plan('ivf_scores', 2, 1, 1024, 64, 256).smem == 131072 + 128


def _insert(v, g, m1, g1, m2, g2):
    """Strict-'<' insertion of ``(v, g)`` into running top-2s (numpy)."""
    new1 = v < m1
    new2 = ~new1 & (v < m2)
    m2n = np.where(new1, m1, np.where(new2, v, m2))
    g2n = np.where(new1, g1, np.where(new2, g, g2))
    return np.where(new1, v, m1), np.where(new1, g, g1), m2n, g2n


def _k6_model(sel, dtable, cb, mb, plan, order):
    """A plain model of K6's work split (csrc/ivf.cu ivf_top2_kernel): each
    CTA of ``plan`` walks its units, keeps running top-2s per selection,
    writes a selection whole in its range and leaves a partial for one its
    range cuts; the last CTA of a cut selection (CTAs finishing in
    ``order``) inserts the pieces in ascending order by adc_merge's rule."""
    tsel = torch.from_numpy(sel)
    acc = tivf._ivf_scores_ref(tsel, torch.from_numpy(dtable), torch.from_numpy(cb))
    safe = np.maximum(sel, 0)
    bias = np.where(mb[safe] > 0, np.float32(0), np.float32(BIG))
    pad = np.where(sel >= 0, np.float32(0), np.float32(BIG))
    # (acc + slot bias) + pad bias in float32 (BIG + BIG is inf): [S, Q, BS]
    with np.errstate(over='ignore'):
        v_all = (acc.numpy() + bias[:, None, :]) + pad[:, None, None]
    nq, n_sel, bs = dtable.shape[0], len(sel), cb.shape[2]
    groups = bs // 128
    s_out = np.full((nq, n_sel * 256), np.nan, np.float32)
    r_out = np.full((nq, n_sel * 256), -1, np.int64)
    part, counters = {}, {}
    lane = np.arange(128)

    def final(t, j, m1, g1, m2, g2):
        qs = slice(t * plan.qt, min(nq, t * plan.qt + plan.qt))
        nrow = qs.stop - qs.start
        s_out[qs, j * 256:j * 256 + 128] = m1[:nrow]
        s_out[qs, j * 256 + 128:j * 256 + 256] = m2[:nrow]
        r_out[qs, j * 256:j * 256 + 128] = j * bs + g1[:nrow] * 128 + lane
        r_out[qs, j * 256 + 128:j * 256 + 256] = (j * bs + np.minimum(g2[:nrow], groups - 1) * 128
                                                  + lane)

    def pieces(j):  # the CTAs of a tile (by index in the tile) holding selection j
        first = j * groups
        return [ci for ci in range(plan.cpt)
                if tivf._unit_lo(plan, ci) <= first + groups - 1
                and tivf._unit_lo(plan, ci + 1) > first]

    for c in order:
        t, ci = divmod(c, plan.cpt)
        lo, hi = tivf._unit_lo(plan, ci), tivf._unit_lo(plan, ci + 1)
        state, cut = None, []

        def flush():
            j, m1, g1, m2, g2 = state
            if j * groups >= lo and (j + 1) * groups <= hi:
                final(t, j, m1, g1, m2, g2)
            else:
                slot = 0 if j * groups <= lo else 1
                part[c, slot] = (m1, g1, m2, g2)
                cut.append(j)

        for u in range(lo, hi):
            j, grp = divmod(u, groups)
            if state is None or state[0] != j:
                if state is not None:
                    flush()
                inf = np.full((plan.qt, 128), np.float32(np.inf))
                zero = np.zeros((plan.qt, 128), np.int64)
                state = (j, inf, zero, inf, zero)
            v = np.full((plan.qt, 128), np.float32(np.inf))
            nrow = min(nq, t * plan.qt + plan.qt) - t * plan.qt
            v[:nrow] = v_all[j, t * plan.qt:t * plan.qt + nrow, grp * 128:grp * 128 + 128]
            state = (j,) + _insert(v, grp, *state[1:])
        flush()
        for j in cut:
            counters[t, j] = counters.get((t, j), 0) + 1
            cs = pieces(j)
            if counters[t, j] < len(cs):
                continue
            m1 = g1 = m2 = g2 = None
            for cc in cs:  # ascending pieces; strict '<' on the scores alone
                slot = 0 if tivf._unit_lo(plan, cc) >= j * groups else 1
                p1, h1, p2, h2 = part[t * plan.cpt + cc, slot]
                if m1 is None:
                    m1, g1, m2, g2 = p1, h1, p2, h2
                    continue
                for vv, gv in ((p1, h1), (p2, h2)):
                    m1, g1, m2, g2 = _insert(vv, gv, m1, g1, m2, g2)
            final(t, j, m1, g1, m2, g2)
    return s_out, r_out


@pytest.mark.parametrize('ctas', [5, 132])
@pytest.mark.parametrize('nq', [1, 2, 7, 9])
@pytest.mark.parametrize('bs,n_sel', [(512, 3), (512, 20), (1024, 17)])
def test_k6_work_split_equal_ref(bs, n_sel, nq, ctas):
    """K6's work split (units over ``ctas`` CTAs, partial top-2s of cut
    selections merged by the last CTA in piece order) equals
    ``_ivf_block_top2_ref`` bit for bit on tie-heavy inputs: a table of few
    values, duplicated code columns and blocks, masked slots, -1 pads; the
    CTAs finish in a shuffled order."""
    rng = np.random.default_rng(bs + n_sel + nq + ctas)
    n_blocks, g = 6, bs // 128
    cb = rng.integers(0, 16, (n_blocks, M, bs)).astype(np.uint8)
    cb[:, :, 128:256] = cb[:, :, :128]  # group 1 repeats group 0
    cb[1] = cb[0]
    mb = (rng.random((n_blocks, bs)) < 0.8).astype(np.int8)
    mb[:, 128:256] = mb[:, :128]
    mb[2, :] = 0  # a block with no live slot
    dtable = rng.integers(0, 3, (nq, M, 16)).astype(np.float32)
    sel = rng.integers(0, n_blocks, n_sel).astype(np.int32)
    sel[:2] = [0, 1]
    sel[-1] = -1
    plan = tivf._top2_plan(nq, n_sel, bs, M, 16, ctas)
    assert plan.units == plan.tiles * n_sel * g and plan.tiles == -(-nq // plan.qt)
    assert plan.grid == plan.tiles * max(1, min(n_sel * g, ctas // plan.tiles))
    order = rng.permutation(plan.grid)
    s, r = _k6_model(sel, dtable, cb, mb, plan, order)
    want_s, want_r = tivf._ivf_block_top2_ref(torch.from_numpy(sel), torch.from_numpy(dtable),
                                              torch.from_numpy(cb), torch.from_numpy(mb))
    np.testing.assert_array_equal(r, want_r.numpy())
    np.testing.assert_array_equal(s, want_s.numpy())
