"""annlite_torch's DocumentArray backend against annlite_tpu's on identical
docs (every case of `tests/test_docarray_compat.py`, the contract of the
reference's `tests/docarray/` suite); the port's arrays carry
``device: 'cpu'`` in their config, JAX runs on the CPU."""
import sqlite3

import numpy as np
import pytest

import annlite_torch.doc as tdoc
import annlite_tpu.doc as jdoc
from annlite_torch.docarray_compat import DocumentArray as TDocumentArray
from annlite_tpu.docarray_compat import DocumentArray as JDocumentArray


def _mk(tmp_path, n_dim=3, storage='annlite_torch', name='da', **cfg):
    cfg = {'n_dim': n_dim, 'data_path': str(tmp_path / name), 'device': 'cpu', **cfg}
    return TDocumentArray(storage=storage, config=cfg)


def _mk_jax(tmp_path, n_dim=3, name='da_jax', **cfg):
    cfg = {'n_dim': n_dim, 'data_path': str(tmp_path / name), **cfg}
    return JDocumentArray(storage='annlite_tpu', config=cfg)


def _docs(n, n_dim=3, mod=tdoc):
    return [mod.Doc(id=f'r{i}', embedding=np.ones(n_dim, np.float32) * i) for i in range(n)]


def _same_matches(t, j):
    assert [m.id for m in t] == [m.id for m in j]
    np.testing.assert_allclose([m.score for m in t], [m.score for m in j], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('storage', ['annlite_torch', 'annlite'])
def test_add(tmp_path, storage):
    da = _mk(tmp_path, n_dim=4, storage=storage)
    da.extend(_docs(6, 4))
    assert len(da) == len(da[:, 'embedding']) == 6
    assert da._annlite.device.type == 'cpu'  # config['device'] reaches AnnLite
    da.close()


def test_unknown_storage_and_missing_dim_raise(tmp_path):
    with pytest.raises(ValueError):
        TDocumentArray(storage='annlite_tpu', config={'n_dim': 3, 'device': 'cpu'})
    with pytest.raises(ValueError):
        TDocumentArray(config={'device': 'cpu'})


def test_add_conflict_id(tmp_path):
    da, ja = _mk(tmp_path, n_dim=4), _mk_jax(tmp_path, n_dim=4)
    for arr, mod in ((da, tdoc), (ja, jdoc)):
        arr.extend(_docs(6, 4, mod))
        with pytest.raises(sqlite3.IntegrityError):
            arr.extend(_docs(3, 4, mod))  # same ids again
    assert len(da._load_ids()) == 6  # no partial extension of alive rows
    assert da._load_ids() == ja._load_ids()


@pytest.mark.parametrize('deleted', [[0, 1], ['r0', 'r1']])
def test_delete_success(tmp_path, deleted):
    da, ja = _mk(tmp_path), _mk_jax(tmp_path)
    for arr, mod in ((da, tdoc), (ja, jdoc)):
        with arr:
            arr.extend(_docs(8, mod=mod))
        with arr:
            del arr[deleted]
    assert len(da._offset2ids.ids) == 6
    assert len(da[:, 'embedding']) == 6
    for doc_id in ['r2', 'r3', 'r4', 'r5', 'r6', 'r7']:
        assert da[doc_id].id == doc_id
    assert da._offset2ids.ids == ja._offset2ids.ids


def test_delete_not_found(tmp_path):
    da = _mk(tmp_path)
    with da:
        da.extend(_docs(2))
    with pytest.raises(ValueError):
        del da['r5']


@pytest.mark.parametrize('nrof_docs', [10, 1000, 10_000])
def test_get_bulk_data(tmp_path, nrof_docs):
    da, ja = _mk(tmp_path), _mk_jax(tmp_path)
    for arr, mod in ((da, tdoc), (ja, jdoc)):
        with arr:
            arr.extend(_docs(nrof_docs, mod=mod))
    ids = da[:, 'id']
    assert len(ids) == nrof_docs
    assert ids == ja[:, 'id']


def test_get_bulk_id_not_exist(tmp_path):
    da = _mk(tmp_path)
    with da:
        da.extend(_docs(10))
    with pytest.raises(KeyError):
        da[['r1', 'r11', 'r21'], 'id']


def test_getitem_shapes(tmp_path):
    da, ja = _mk(tmp_path), _mk_jax(tmp_path)
    da.extend(_docs(10))
    ja.extend(_docs(10, mod=jdoc))
    assert da[0].id == 'r0'
    assert da[-1].id == 'r9'
    assert [d.id for d in da[2:4]] == ['r2', 'r3']
    assert da['r7'].id == 'r7'
    np.testing.assert_allclose(da['r7', 'embedding'], np.ones(3) * 7)
    assert [d.id for d in da][:3] == ['r0', 'r1', 'r2']
    for key in (0, -1, slice(2, 5), 'r7', ['r1', 'r3'], np.array([4, 5])):
        t, j = da[key, 'embedding'], ja[key, 'embedding']
        assert np.asarray(t).tobytes() == np.asarray(j).tobytes()


@pytest.mark.parametrize('metric', ['euclidean', 'cosine'])
def test_find(tmp_path, metric):
    # i*ones are collinear, so under cosine every row but r0 ties: ids are
    # compared under euclidean only
    da, ja = _mk(tmp_path, metric=metric), _mk_jax(tmp_path, metric=metric)
    for arr, mod in ((da, tdoc), (ja, jdoc)):
        with arr:
            arr.extend(_docs(1000, mod=mod))
    q = np.array([2, 1, 3], np.float32)
    matches = da.find(q, limit=10, num_candidates=100)
    assert len(matches) == 10
    scores = [m.score for m in matches]
    assert scores == sorted(scores)
    jm = ja.find(q, limit=10, num_candidates=100)
    if metric == 'euclidean':
        # nearest row to [2,1,3] under L2 is r2
        assert matches[0].id == 'r2'
        _same_matches(matches, jm)
    else:
        np.testing.assert_allclose(scores, [m.score for m in jm], rtol=1e-5, atol=1e-6)
    # a [Q, D] batch: one list of matches per query
    qb = np.stack([q, q * 2 + 1]).astype(np.float32)
    tb, jb = da.find(qb, limit=5), ja.find(qb, limit=5)
    assert len(tb) == 2
    if metric == 'euclidean':
        for t, j in zip(tb, jb):
            _same_matches(t, j)


def test_find_with_filter(tmp_path):
    cfg = dict(n_dim=3, metric='euclidean', columns=[('price', float)])
    da, ja = _mk(tmp_path, **cfg), _mk_jax(tmp_path, **cfg)
    for arr, mod in ((da, tdoc), (ja, jdoc)):
        arr.extend([mod.Doc(id=f'r{i}', embedding=np.ones(3, np.float32) * i,
                            tags={'price': float(i % 7)}) for i in range(200)])
    flt = {'price': {'$lt': 2.0}}
    t = da.find(np.full(3, 50.0, np.float32), limit=10, filter=flt)
    assert all(int(m.id[1:]) % 7 < 2 for m in t)
    _same_matches(t, ja.find(np.full(3, 50.0, np.float32), limit=10, filter=flt))


def test_save_load(tmp_path):
    N = 100
    rng = np.random.default_rng(0)
    x = rng.random((2 * N, 8), np.float32)
    da = _mk(tmp_path, n_dim=8)
    for i in range(N):
        da.append(tdoc.Doc(id=str(i), embedding=x[i]))
    da._annlite.close()

    da2 = _mk(tmp_path, n_dim=8)
    assert len(da2) == N
    # a reopen without a snapshot rebuilds from the doc store, so offsets
    # follow store order; the id SET must round-trip exactly
    assert set(da2._offset2ids.ids) == {str(i) for i in range(N)}
    for i in range(N, N + N):
        da2.append(tdoc.Doc(id=str(i), embedding=x[i]))
    assert len(da2) == N + N
    # the JAX backend reopens the same data path to the same array
    da2._annlite.close()
    ja = JDocumentArray(storage='annlite_tpu',
                        config={'n_dim': 8, 'data_path': str(tmp_path / 'da')})
    da3 = _mk(tmp_path, n_dim=8)
    assert ja._offset2ids.ids == da3._offset2ids.ids
    ja.close()
    da3.close()


def test_save_load_with_snapshot_keeps_offsets(tmp_path):
    """With a snapshot (`dump()`), reopen restores the cell table verbatim,
    so offset order survives exactly."""
    N = 50
    rng = np.random.default_rng(1)
    x = rng.random((N, 8), np.float32)
    da = _mk(tmp_path, n_dim=8)
    for i in range(N):
        da.append(tdoc.Doc(id=str(i), embedding=x[i]))
    da._annlite.dump()
    da._annlite.close()

    da2 = _mk(tmp_path, n_dim=8)
    assert da2._offset2ids.ids == [str(i) for i in range(N)]
    assert da2[0].id == '0' and da2[-1].id == str(N - 1)
    da2.close()
    ja = JDocumentArray(storage='annlite_tpu',
                        config={'n_dim': 8, 'data_path': str(tmp_path / 'da')})
    assert ja._offset2ids.ids == [str(i) for i in range(N)]
    ja.close()


def test_delete_partial_batch_resyncs_offsets(tmp_path):
    """A batch delete containing a missing id raises, but earlier ids in the
    batch may already be gone: the offset map resyncs with the table."""
    da, ja = _mk(tmp_path), _mk_jax(tmp_path)
    for arr, mod in ((da, tdoc), (ja, jdoc)):
        with arr:
            arr.extend(_docs(6, mod=mod))
        with pytest.raises(ValueError):
            del arr[['r0', 'r1', 'nope']]
    # offset map matches the table exactly (whatever the table now holds)
    assert da._offset2ids.ids == da._load_ids()
    assert len(da) == len(da[:, 'embedding'])
    assert da._offset2ids.ids == ja._offset2ids.ids


def test_find_num_candidates_widens_then_truncates(tmp_path):
    da = _mk(tmp_path, n_dim=4, metric='euclidean')
    da.extend(_docs(30, 4))
    seen = {}
    orig = da._annlite.search

    def spy(docs, filter=None, limit=10, **kw):
        seen['limit'] = limit
        return orig(docs, filter=filter, limit=limit, **kw)

    da._annlite.search = spy
    out = da.find(np.ones(4, np.float32) * 3, limit=5, num_candidates=20)
    assert seen['limit'] == 20       # widened internal pool
    assert len(out) == 5             # truncated back to limit
    assert out[0].id == 'r3'
