"""The port's multi-host path rehearsed on the CPU: two port processes
joined by gloo, 4 virtual shards each, run ``sharded_adc_topk_2d`` and
``sharded_lloyd_step_2d`` (`tests/torch_distributed_worker.py`); their
results are held against the JAX functions on a single-process (2, 4)
hybrid mesh of this process's virtual CPU devices, on the same data."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_parity import assert_topk_close

sys.path.insert(0, str(Path(__file__).parent))
import torch_distributed_worker as worker  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_reference():
    from jax.sharding import PartitionSpec as P

    from annlite_tpu.parallel import distributed as jd

    mesh = jd.make_hybrid_mesh((2, 4))
    dtable, codes, mask, x, c0 = worker.make_data()
    ct = jd.shard_codes_2d(mesh, codes)
    mk = jd.shard_mask_2d(mesh, mask, ct.shape[1])
    d, idx = jd.sharded_adc_topk_2d(mesh, jd.replicate_2d(mesh, dtable), ct, mk, 10)
    xs = jd.put_sharded(mesh, x, P((jd.HOST_AXIS, jd.ICI_AXIS), None))
    c, inertia = jd.sharded_lloyd_step_2d(mesh, xs, jd.replicate_2d(mesh, c0))
    return np.asarray(d), np.asarray(idx), np.asarray(c), float(inertia)


def test_two_process_hierarchical_search_equal_jax(tmp_path):
    if jax.device_count() < 8:
        pytest.skip('needs 8 JAX devices (tests/conftest.py sets 8)')
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(pid), str(port),
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and 'DIST_OK' in out, f'worker failed (rc={rc}):\n{out}\n{err[-2000:]}'
    jd_, ji, jc, jinertia = _jax_reference()
    ranks = [np.load(tmp_path / f'rank{pid}.npz') for pid in (0, 1)]
    for key in ('d', 'idx', 'c', 'inertia'):  # replicated: the same on both ranks
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    r = ranks[0]
    assert_topk_close(r['d'], r['idx'], jd_, ji)
    _, codes, mask, _, _ = worker.make_data()
    assert mask[r['idx']].all()
    np.testing.assert_allclose(r['c'], jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(r['inertia']), jinertia, rtol=1e-5)


def test_init_distributed_defaults_to_the_card():
    """``backend=None`` means NCCL, the card's backend: without CUDA it
    raises, as every entry point of the port does, and joins no group."""
    from annlite_torch.parallel.distributed import init_distributed

    if torch.cuda.is_available():
        pytest.skip('checks the refusal without CUDA')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_distributed(f'localhost:{_free_port()}', 1, 0)
    assert not dist.is_initialized()
