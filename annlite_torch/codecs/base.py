"""Codec base class — the port of `annlite_tpu/codecs/base.py`.

Serialization is ``np.savez`` (arrays) + JSON (params, with the class name
under ``cls``), byte for byte the JAX package's: a ``pq.npz`` or ``vq.npz``
written by either package loads in the other.  ``load`` also takes the
``device`` the codec computes on (``None`` means the card).
"""
import abc
import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch


class BaseCodec(abc.ABC):
    def __init__(self, require_train: bool = True):
        self.require_train = require_train
        self._is_trained = False

    @property
    def is_trained(self) -> bool:
        if not self.require_train:
            return True
        return self._is_trained

    def _check_trained(self):
        if not self.is_trained:
            raise RuntimeError(
                f'{self.__class__.__name__} has not been trained; call `fit` first'
            )

    @abc.abstractmethod
    def fit(self, x: np.ndarray):
        ...

    @abc.abstractmethod
    def encode(self, x: np.ndarray):
        ...

    @abc.abstractmethod
    def decode(self, x: np.ndarray):
        ...

    # ----- serialization -----

    def _state(self) -> Dict:
        """Return {'params': json-able dict, 'arrays': {name: np.ndarray}}."""
        raise NotImplementedError

    def _restore(self, params: Dict, arrays: Dict[str, np.ndarray],
                 device: Optional[Union[str, torch.device]] = None):
        raise NotImplementedError

    def dump(self, target_path: Union[str, Path]):
        target_path = Path(target_path)
        state = self._state()
        payload = {f'arr__{k}': v for k, v in state['arrays'].items()}
        payload['params_json'] = np.frombuffer(
            json.dumps(
                {'cls': self.__class__.__name__, **state['params']}
            ).encode('utf-8'),
            dtype=np.uint8,
        )
        target_path.parent.mkdir(parents=True, exist_ok=True)
        with open(target_path, 'wb') as f:
            np.savez(f, **payload)

    @classmethod
    def load(cls, from_path: Union[str, Path],
             device: Optional[Union[str, torch.device]] = None) -> 'BaseCodec':
        with np.load(Path(from_path), allow_pickle=False) as z:
            params = json.loads(bytes(z['params_json']).decode('utf-8'))
            if params.pop('cls') != cls.__name__:
                raise ValueError(f'{from_path} does not hold a {cls.__name__}')
            arrays = {
                k[len('arr__'):]: z[k] for k in z.files if k.startswith('arr__')
            }
        obj = cls.__new__(cls)
        obj._restore(params, arrays, device)
        return obj
