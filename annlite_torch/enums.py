"""Metric / expansion enums.

Parity with reference `annlite/enums.py:4-34` (Metric, ExpandMode,
BetterEnum.from_string), re-expressed for the TPU build.
"""
from enum import IntEnum


class BetterEnum(IntEnum):
    """IntEnum with case-insensitive string constructor."""

    @classmethod
    def from_string(cls, text: str) -> "BetterEnum":
        try:
            return cls[text.upper()]
        except KeyError:
            raise ValueError(
                f'{text} is not a valid enum for {cls!r}, '
                f'choose from {[e.name.lower() for e in cls]}'
            )


class Metric(BetterEnum):
    EUCLIDEAN = 1
    INNER_PRODUCT = 2
    COSINE = 3


class ExpandMode(BetterEnum):
    STEP = 1
    DOUBLE = 2
    ADAPTIVE = 3


def parse_metric(metric) -> Metric:
    """Accept Metric | str and return Metric."""
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str):
        return Metric.from_string(metric)
    raise TypeError(f'cannot interpret {metric!r} as a Metric')
