"""Worker of the two-process rehearsal in `tests/test_torch_distributed.py`:
one of two port processes joined by gloo on the CPU, 4 virtual shards each.

    python torch_distributed_worker.py <pid> <port> <out_dir>

Both processes make the same data (same seed), run the hierarchical
host x shard ADC search and the 2-D Lloyd step, and write their replicated
results to ``<out_dir>/rank<pid>.npz``; the test holds them against the JAX
functions.  Prints DIST_OK on success."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the data of both sides of the test
Q, N, M, K, KC, NL, DIM = 4, 600, 8, 16, 8, 640, 16


def make_data():
    rng = np.random.default_rng(0)
    dtable = rng.uniform(0, 10, (Q, M, K)).astype(np.float32)
    codes = rng.integers(0, K, (M, N)).astype(np.uint8)
    mask = rng.random(N) < 0.8
    x = rng.standard_normal((NL, DIM)).astype(np.float32)
    return dtable, codes, mask, x, x[:KC].copy()


def main():
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import torch.distributed as dist

    from annlite_torch.parallel.distributed import (init_distributed, make_hybrid_mesh,
                                                    put_sharded, replicate_2d, shard_codes_2d,
                                                    shard_mask_2d, sharded_adc_topk_2d,
                                                    sharded_lloyd_step_2d)

    for _ in range(2):  # the second call is a no-op
        init_distributed(f'localhost:{port}', num_processes=2, process_id=pid, backend='gloo')
    try:
        mesh = make_hybrid_mesh((2, 4), device='cpu')
        assert mesh.shape == (2, 4) and mesh.host == pid and mesh.local.size == 4
        dtable, codes, mask, x, c0 = make_data()
        ct = shard_codes_2d(mesh, codes)
        mk = shard_mask_2d(mesh, mask, ct[0].shape[1] * mesh.size)
        d, idx = sharded_adc_topk_2d(mesh, replicate_2d(mesh, dtable), ct, mk, 10)
        c, inertia = sharded_lloyd_step_2d(mesh, put_sharded(mesh, x, 0), c0)
        np.savez(os.path.join(out, f'rank{pid}.npz'), d=d.numpy(), idx=idx.numpy(),
                 c=c.numpy(), inertia=float(inertia))
    finally:
        dist.destroy_process_group()
    print('DIST_OK', flush=True)


if __name__ == '__main__':
    main()
