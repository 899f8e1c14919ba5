"""Document model — the port's copy of `annlite_tpu/doc.py`.

``Doc`` is serialized as msgpack (``use_bin_type=True``), the same bytes the
JAX package's ``Doc.to_bytes`` writes, so either package can open the other's
doc store.  The msgpack package itself is not a dependency: this module
writes and reads the subset of the format that ``Doc`` uses (map, str, bin,
int, float, bool, nil, array), following the choices of msgpack's own packer
(smallest integer form, float64 for every float, str8 allowed).
"""
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def _np_default(obj):
    """Fallback for values msgpack does not know: numpy scalars in tags
    (np.int64 bucket ids etc.) serialize as their Python equivalents."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f'cannot serialize {type(obj)!r} in Doc tags')


def _sized(out: bytearray, n: int, small: Optional[int], forms):
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``small`` (its tag) applies, else the first of ``forms`` that fits."""
    if small is not None:
        out.append(small | n)
        return
    for tag, fmt, limit in forms:
        if n < limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f'object too large to serialize ({n})')


_STR = ((0xD9, '>B', 1 << 8), (0xDA, '>H', 1 << 16), (0xDB, '>I', 1 << 32))
_BIN = ((0xC4, '>B', 1 << 8), (0xC5, '>H', 1 << 16), (0xC6, '>I', 1 << 32))
_ARR = ((0xDC, '>H', 1 << 16), (0xDD, '>I', 1 << 32))
_MAP = ((0xDE, '>H', 1 << 16), (0xDF, '>I', 1 << 32))


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for tag, fmt, limit in ((0xCC, '>B', 1 << 8), (0xCD, '>H', 1 << 16),
                                (0xCE, '>I', 1 << 32), (0xCF, '>Q', 1 << 64)):
            if v < limit:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError('Integer value out of range')
    else:
        for tag, fmt, limit in ((0xD0, '>b', 1 << 7), (0xD1, '>h', 1 << 15),
                                (0xD2, '>i', 1 << 31), (0xD3, '>q', 1 << 63)):
            if v >= -limit:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError('Integer value out of range')


def _pack(out: bytearray, obj, default_used: bool = False):
    # the order of the checks is msgpack's: bool before int (bool is an int
    # subclass), and subclasses of int/float/str (np.float64, np.str_) take
    # the builtin's form without the fallback
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack('>d', obj)
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), None, _BIN)
        out += obj
    elif isinstance(obj, str):
        b = obj.encode('utf-8')
        _sized(out, len(b), 0xA0 if len(b) < 32 else None, _STR)
        out += b
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80 if len(obj) < 16 else None, _MAP)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90 if len(obj) < 16 else None, _ARR)
        for v in obj:
            _pack(out, v)
    elif not default_used:
        _pack(out, _np_default(obj), default_used=True)
    else:
        raise TypeError(f'cannot serialize {type(obj)!r}')


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True, default=_np_default)``."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# type byte -> value, number format, or length format of str/bin/array/map
_CONSTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: '>B', 0xCD: '>H', 0xCE: '>I', 0xCF: '>Q', 0xD0: '>b',
            0xD1: '>h', 0xD2: '>i', 0xD3: '>q', 0xCA: '>f', 0xCB: '>d'}
_LENGTHS = {0xC4: '>B', 0xC5: '>H', 0xC6: '>I', 0xD9: '>B', 0xDA: '>H',
            0xDB: '>I', 0xDC: '>H', 0xDD: '>I', 0xDE: '>H', 0xDF: '>I'}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError('truncated msgpack data')
        b = self.data[self.at:self.at + n]
        self.at += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), 'utf-8')
        if t in _CONSTS:
            return _CONSTS[t]
        if t in _NUMBERS:
            return self.unpack(_NUMBERS[t])
        if t not in _LENGTHS:
            raise ValueError(f'unsupported msgpack type byte 0x{t:02x}')
        n = self.unpack(_LENGTHS[t])
        if t <= 0xC6:
            return bytes(self.take(n))
        if t <= 0xDB:
            return str(self.take(n), 'utf-8')
        if t <= 0xDD:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset ``packb`` writes."""
    r = _Reader(data)
    obj = r.read()
    if r.at != len(r.data):
        raise ValueError('extra data after the msgpack object')
    return obj


@dataclass
class Doc:
    id: str
    embedding: Optional[np.ndarray] = None
    tags: Dict[str, Any] = field(default_factory=dict)
    # populated on search results
    score: Optional[float] = None
    matches: List['Doc'] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        payload = {'id': self.id, 'tags': self.tags}
        if self.embedding is not None:
            emb = np.ascontiguousarray(self.embedding)
            payload['emb'] = emb.tobytes()
            payload['emb_dtype'] = str(emb.dtype)
            payload['emb_shape'] = list(emb.shape)
        return packb(payload)

    @classmethod
    def from_bytes(cls, data: bytes) -> 'Doc':
        payload = unpackb(data)
        emb = None
        if 'emb' in payload:
            emb = np.frombuffer(
                payload['emb'], dtype=np.dtype(payload['emb_dtype'])
            ).reshape(payload['emb_shape'])
        return cls(id=payload['id'], embedding=emb, tags=payload.get('tags', {}))

    def copy_without_embedding(self) -> 'Doc':
        return Doc(id=self.id, tags=dict(self.tags))


def docs_to_embeddings(docs: List[Doc]) -> np.ndarray:
    """Stack doc embeddings into [n, dim] float32 (errors on missing)."""
    embs = []
    for d in docs:
        if d.embedding is None:
            raise ValueError(f'doc {d.id} has no embedding')
        embs.append(np.asarray(d.embedding, dtype=np.float32).reshape(-1))
    return np.stack(embs)
