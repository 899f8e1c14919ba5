"""Build and load the port's CUDA kernels.

Each ``annlite_torch/csrc/*.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The libraries go
into ``build/annlite_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, at the first CUDA launch (or by
:func:`build`).  All sources compile at once, one ``nvcc`` each.  Nothing is
downloaded and no binary is committed; importing this module needs neither
``nvcc`` nor a card.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'annlite_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are void*, every size an int
SIGNATURES = {
    'fused_scan': {
        'annlite_block_top2': [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
        'annlite_lane8_merge': [_P] * 4 + [_I] * 2 + [_P],
    },
    'gather': {
        'annlite_gather_rerank': [_P] * 4 + [_I] * 6 + [_P],
    },
    'adc': {
        'annlite_adc_scores': [_P] * 4 + [_I] * 6 + [_P],
        'annlite_adc_block_top2': [_P] * 5 + [_I] * 7 + [_P],
        'annlite_ivf_scores': [_P] * 4 + [_I] * 6 + [_P],
        'annlite_ivf_block_top2': [_P] * 6 + [_I] * 6 + [_P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (Path(cuda_home) / 'bin' / 'nvcc', shutil.which('nvcc')):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from annlite_torch/csrc at first use')


def _build_dir() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source that is not built yet, all at once; returns the
    library path of each.  A library is renamed into place only when complete,
    so concurrent builds never load a partial file."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f'lib{name}.so' for name in SIGNATURES}
    todo = {name: p for name, p in libs.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, lib in todo.items():
            tmp = Path(tempfile.mkstemp(dir=out, suffix='.so.tmp')[1])
            cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f'{name}.cu:\n{log}')
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build()[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err}')


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card, as a pointer for the C entry
    points: kernels launch where PyTorch's own work on it goes."""
    return torch.cuda.current_stream(t.device).cuda_stream
