#!/usr/bin/env python3
"""The device Vamana build (``annlite_torch/index/device_build.py``) alone,
on one NVIDIA GPU, at the size of ``chip_smoke.py``'s ``graph`` phase.

    python3 scripts/device_build_probe.py

Builds 131,072 x 128 euclidean rows (1024 centres x 2.0 plus unit noise,
numpy seed 1234, as ``bench.py``'s ``_graph_corpus``) through
``DeviceVamanaBuilder(128, max_degree=32, l_build=64)`` with the builder's
defaults otherwise, after a 2,048-row build that warms the card's
libraries.  Prints one JSON line: the card's name and power limit, the
build's seconds and rows/s, its seconds and share by stage, the peak device
bytes of the build, and the reachable share and degree bounds of the graph.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('device_build_probe: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from annlite_torch import profile
    from annlite_torch.index.device_build import DeviceVamanaBuilder

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True)
    n, d = 131072, 128
    rng = np.random.default_rng(1234)
    cent = (rng.standard_normal((1024, d)) * 2.0).astype(np.float32)
    x = (cent[rng.integers(0, 1024, n)] + rng.standard_normal((n, d))).astype(np.float32)
    DeviceVamanaBuilder(d, max_degree=32, l_build=64).add(x[:2048])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    b = DeviceVamanaBuilder(d, max_degree=32, l_build=64)
    spans0 = profile.snapshot()['spans']
    t0 = time.perf_counter()
    b.add(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    # the build's stages: its spans annlite.build.<stage> in the tracer
    stage_s = {k[len('annlite.build.'):]:
               (v['total_ns'] - spans0.get(k, {}).get('total_ns', 0)) * 1e-9
               for k, v in profile.snapshot()['spans'].items() if k.startswith('annlite.build.')}
    adj = b.raw_adjacency()
    deg = (adj >= 0).sum(axis=1)
    self_loops = int((adj == np.arange(n)[:, None]).sum())
    print(json.dumps({
        'card': smi.stdout.strip(), 'rows': n, 'dim': d, 'w': b.w,
        'build_s': build_s, 'rows_per_s': n / build_s,
        'stage_s': stage_s, 'stage_share': {k: v / build_s for k, v in stage_s.items()},
        'peak_device_bytes': peak, 'reachable_fraction': float(b._reachable_mask().mean()),
        'degree_max': int(deg.max()), 'degree_mean': float(deg.mean()),
        'self_loops': self_loops}))
    ok = b._reachable_mask().mean() >= 0.999 and deg.max() <= b.w and self_loops == 0
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
