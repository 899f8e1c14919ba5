"""annlite_torch — filterable vector search on PyTorch and CUDA (Hopper).

The port of ``annlite_tpu`` to PyTorch with hand-written CUDA kernels for the
NVIDIA H100.  It imports nothing of the JAX package.  Entry points run on the
card by default (``device=None`` means ``'cuda'``, and raises when CUDA is
absent); ``device='cpu'`` runs the kernels' plain PyTorch versions.
"""

__version__ = '0.1.0'

from .enums import ExpandMode, Metric
from .filter import Filter

__all__ = ['Metric', 'ExpandMode', 'Filter', 'AnnLite', '__version__']


def __getattr__(name):
    # lazy import keeps `import annlite_torch` light
    if name == 'AnnLite':
        from .index_api import AnnLite

        return AnnLite
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
