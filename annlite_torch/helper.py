"""Logging + dtype helpers (reference `annlite/helper.py`).

Uses stdlib logging instead of loguru (not available in this environment).
"""
import logging
import sys

import numpy as np

_LOGGERS = {}


def setup_logging(debug: bool = False, name: str = 'annlite_torch') -> logging.Logger:
    """Mirror of reference `annlite/helper.py:7-21` on stdlib logging."""
    if name in _LOGGERS:
        logger = _LOGGERS[name]
        logger.setLevel(logging.DEBUG if debug else logging.INFO)
        return logger
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter(
                '%(asctime)s | %(levelname)-7s | %(name)s:%(funcName)s:%(lineno)d - %(message)s'
            )
        )
        logger.addHandler(h)
    logger.propagate = False
    _LOGGERS[name] = logger
    return logger


def str2dtype(dtype_str: str) -> np.dtype:
    """Parse a dtype string (reference `annlite/helper.py:24-47`)."""
    if not isinstance(dtype_str, str):
        raise TypeError(f'expected a dtype string, got {type(dtype_str).__name__}')
    try:
        return np.dtype(dtype_str)
    except TypeError:
        raise TypeError(f'convert {dtype_str} to numpy dtype failed')
