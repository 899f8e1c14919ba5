"""Build and load the port's CUDA kernels.

Each ``annlite_torch/csrc/*.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (``*.cuh`` are
headers they include).  The libraries go
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
import threading
from pathlib import Path
from typing import Dict

import torch

from ..profile import count, span

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'annlite_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are void*, every size an int
SIGNATURES = {
    'fused_scan': {
        'annlite_block_top2': [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
        'annlite_block_top2_int4': [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
        'annlite_block_top2_bf16': [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
        'annlite_lane8_merge': [_P] * 4 + [_I] * 3 + [_P],
        'annlite_block_pass_info': [_I] * 4 + [_P],
    },
    'gather': {
        'annlite_gather_rerank': [_P] * 4 + [_I] * 7 + [_P],
        'annlite_gather_info': [_I] * 2 + [_P],
    },
    'adc': {
        'annlite_adc_scores': [_P] * 5 + [_I] * 6 + [_P] * 2,
        'annlite_adc_block_top2': [_P] * 8 + [_I] * 7 + [_P] * 2,
        'annlite_ivf_scores': [_P] * 5 + [_I] * 6 + [_P] * 2,
        'annlite_ivf_block_top2': [_P] * 9 + [_I] * 6 + [_P] * 2,
        'annlite_adc_info': [_I] * 3 + [_P],
    },
    'ivf': {
        'annlite_ivf_rows': [_P] * 4 + [_I] * 8 + [_P],
        'annlite_ivf_top2': [_P] * 9 + [_I] * 9 + [_P],
        'annlite_ivf_info': [_I] * 4 + [_P],
    },
    'lut_pq': {
        'annlite_lut_pq_scores': [_P] * 4 + [_I] * 6 + [_P],
    },
    'beam_pq': {
        'annlite_beam_pq': [_P] * 7 + [_I] * 14 + [_P],
    },
    'beam_vec': {
        'annlite_beam_vec': [_P] * 8 + [_I] * 14 + [_P],
    },
    'adc_i8': {
        'annlite_adc_i8_scores': [_P] * 7 + [_I] * 6 + [_P] * 2,
        'annlite_adc_i8_info': [_I] * 2 + [_P],
    },
    'masked_scan': {
        'annlite_masked_scan': [_P] * 9 + [_I] * 10 + [_P],
        'annlite_masked_scan_info': [_I] * 3 + [_P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
# the serving layer launches from several threads: one builds and loads, the
# others wait for it
_load_lock = threading.Lock()


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
        with span('annlite.kernels.build'):
            _compile(todo, out)
    return libs


def _compile(todo: Dict[str, Path], out: Path):
    """Run one ``nvcc`` per library of ``todo``, all at once; counts the
    libraries built in ``kernels_built``."""
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
            count('kernels_built')
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
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
