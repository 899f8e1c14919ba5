"""ctypes bindings for the host Vamana graph builder — the port of
`annlite_tpu/index/vamana_lib.py`.

The port compiles its own copy of the builder, ``annlite_torch/csrc/
vamana.cpp``, with ``g++`` at first use into ``build/annlite_torch/<hash>/
libvamana.so`` at the root of the checkout, keyed by a hash of the source and
the flags.  It never loads ``native/libvamana.so`` nor the JAX package's
``_native`` library: a library built with ``-march=native`` on another CPU
may die there with SIGILL, so the key also holds the host CPU's model and
flags.  The build is host code, so it needs ``g++`` and no card; a lock file
serialises concurrent builds (test workers), and the library is renamed into
place only when complete.
"""
import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops._ext import BUILD_ROOT, CSRC

SOURCE = CSRC / 'vamana.cpp'
CXX_FLAGS = ['-O3', '-march=native', '-std=c++17', '-fPIC', '-pthread', '-shared']
_lib = None


def _cpu_key() -> bytes:
    """The host CPU's model and instruction-set flags (what -march=native
    compiles for)."""
    try:
        info = Path('/proc/cpuinfo').read_text().splitlines()
    except OSError:
        info = []
    keep = [ln for ln in info if ln.startswith(('model name', 'flags', 'Features'))][:2]
    return '\n'.join([platform.machine(), *keep]).encode()


def library_path() -> Path:
    """Where the library of the current source, flags and CPU lives."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_key())
    return BUILD_ROOT / h.hexdigest()[:16] / 'libvamana.so'


def build() -> Path:
    """Compile the builder if it is not built yet; returns the library."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / 'libvamana.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            cxx = shutil.which('g++') or shutil.which('c++')
            if cxx is None:
                raise RuntimeError('g++ not found: the Vamana builder is compiled '
                                   'from annlite_torch/csrc/vamana.cpp at first use')
            tmp = Path(tempfile.mkstemp(dir=lib.parent, suffix='.so.tmp')[1])
            r = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), '-o', str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'g++ failed on {SOURCE.name}:\n{r.stderr}')
            os.replace(tmp, lib)
    return lib


def load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int32_p = ctypes.POINTER(ctypes.c_int32)
    lib.vamana_create.restype = ctypes.c_void_p
    lib.vamana_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ]
    lib.vamana_destroy.argtypes = [ctypes.c_void_p]
    lib.vamana_size.argtypes = [ctypes.c_void_p]
    lib.vamana_size.restype = ctypes.c_int
    lib.vamana_medoid.argtypes = [ctypes.c_void_p]
    lib.vamana_medoid.restype = ctypes.c_int
    lib.vamana_add.argtypes = [ctypes.c_void_p, c_float_p, ctypes.c_int, ctypes.c_int]
    lib.vamana_get_adjacency.argtypes = [ctypes.c_void_p, c_int32_p]
    lib.vamana_load.argtypes = [ctypes.c_void_p, c_float_p, c_int32_p, ctypes.c_int]
    lib.vamana_update.argtypes = [ctypes.c_void_p, c_int32_p, c_float_p, ctypes.c_int]
    lib.vamana_search.argtypes = [
        ctypes.c_void_p, c_float_p, ctypes.c_int, ctypes.c_int, c_int32_p, c_float_p,
    ]
    _lib = lib
    return lib


def _fp(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class VamanaGraph:
    """Thin RAII wrapper over the C graph handle."""

    def __init__(self, dim: int, max_degree: int = 32, alpha: float = 1.2,
                 metric_ip: bool = False, l_build: int = 64):
        self.lib = load_lib()
        self.dim = dim
        self.max_degree = max_degree
        self.alpha = alpha
        self.metric_ip = metric_ip
        self.l_build = l_build
        self._h = self.lib.vamana_create(
            dim, max_degree, ctypes.c_float(alpha), 1 if metric_ip else 0, l_build
        )

    def __del__(self):
        try:
            if getattr(self, '_h', None):
                self.lib.vamana_destroy(self._h)
        except Exception:
            pass

    @property
    def size(self) -> int:
        return self.lib.vamana_size(self._h)

    @property
    def medoid(self) -> int:
        return self.lib.vamana_medoid(self._h)

    def add(self, x, n_threads: int = 0):
        """Append and link rows; ``n_threads=0`` uses every host thread (a
        multi-threaded build is not deterministic)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        assert x.ndim == 2 and x.shape[1] == self.dim
        self.lib.vamana_add(self._h, _fp(x), x.shape[0], n_threads)

    def update(self, ids, x):
        """In-place vector update + rewire (hnswlib `updatePoint` parity):
        overwrite stored vectors at ``ids``, then re-insert each point."""
        ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
        x = np.ascontiguousarray(x, dtype=np.float32)
        assert x.shape == (len(ids), self.dim)
        assert len(ids) == 0 or (ids.min() >= 0 and ids.max() < self.size)
        if len(ids):
            self.lib.vamana_update(self._h, _ip(ids), _fp(x), len(ids))

    def adjacency(self):
        n = self.size
        out = np.empty((n, self.max_degree), dtype=np.int32)
        if n:
            self.lib.vamana_get_adjacency(self._h, _ip(out))
        return out

    def load(self, x, adjacency):
        x = np.ascontiguousarray(x, dtype=np.float32)
        adjacency = np.ascontiguousarray(adjacency, dtype=np.int32)
        assert adjacency.shape == (x.shape[0], self.max_degree)
        self.lib.vamana_load(self._h, _fp(x), _ip(adjacency), x.shape[0])

    def search(self, q, k: int = 10, L: int = 64):
        """Host-side reference search (parity checks only)."""
        q = np.ascontiguousarray(q, dtype=np.float32).reshape(-1)
        ids = np.empty(k, dtype=np.int32)
        ds = np.empty(k, dtype=np.float32)
        self.lib.vamana_search(self._h, _fp(q), k, L, _ip(ids), _fp(ds))
        return ds, ids
