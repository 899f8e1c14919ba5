"""MongoDB-style filter compiler.

Parity with reference `annlite/filter.py` ($and/$or `filter.py:3`, relational
ops `filter.py:5-12`, $in/$nin `filter.py:14`, recursive `_sql_parsing`
`filter.py:17-90`, `Filter.parse_where_clause` `filter.py:93-100`), with two
back-ends instead of one:

1. ``parse_where_clause()`` — parameterized SQL WHERE clause for the host-side
   SQLite cell tables (same contract as the reference).
2. ``compile_predicate()`` — a vectorized numpy predicate over columnar
   arrays producing a boolean bitmask, which is shipped to the device and
   fused into the scoring kernel.  This replaces the reference's binary
   fuse16 filter (`include/hnswlib/fusefilter.h`) with an *exact* mask.

We accept both ``$ne`` (advertised in the reference README:219) and ``$neq``
(what the reference actually implements) — a deliberate superset.
"""
from typing import Dict, List, Tuple

import numpy as np

LOGICAL_OPERATORS = {'$and': 'AND', '$or': 'OR'}

COMPARISON_OPERATORS = {
    '$lt': '<',
    '$gt': '>',
    '$lte': '<=',
    '$gte': '>=',
    '$eq': '=',
    '$neq': '!=',
    '$ne': '!=',
}

MEMBERSHIP_OPERATORS = {'$in': 'IN', '$nin': 'NOT IN'}

SUPPORTED_OPERATORS = {
    **LOGICAL_OPERATORS,
    **COMPARISON_OPERATORS,
    **MEMBERSHIP_OPERATORS,
}


def _sql_parsing(condition: Dict) -> Tuple[str, List]:
    clauses: List[str] = []
    params: List = []
    for key, value in condition.items():
        if key in LOGICAL_OPERATORS:
            if not isinstance(value, list):
                raise ValueError(f'The value of operator `{key}` must be a list')
            sub = [_sql_parsing(c) for c in value]
            joiner = f' {LOGICAL_OPERATORS[key]} '
            clauses.append('(' + joiner.join(s for s, _ in sub) + ')')
            for _, p in sub:
                params.extend(p)
        elif key.startswith('$'):
            raise ValueError(f'The operator `{key}` is not supported')
        else:
            # key is a column name; value is {op: operand} or a bare value
            if not isinstance(value, dict):
                value = {'$eq': value}
            for op, operand in value.items():
                if op in COMPARISON_OPERATORS:
                    clauses.append(f'({key} {COMPARISON_OPERATORS[op]} ?)')
                    params.append(operand)
                elif op in MEMBERSHIP_OPERATORS:
                    if not isinstance(operand, (list, tuple)):
                        raise ValueError(
                            f'The value of operator `{op}` must be a list'
                        )
                    holes = ', '.join('?' for _ in operand)
                    clauses.append(f'({key} {MEMBERSHIP_OPERATORS[op]} ({holes}))')
                    params.extend(operand)
                else:
                    raise ValueError(f'The operator `{op}` is not supported')
    if not clauses:
        return '', []
    return ' AND '.join(clauses) if len(clauses) > 1 else clauses[0], params


class Filter:
    """Compiled filter over tag columns (reference `annlite/filter.py:93`)."""

    def __init__(self, conditions: Dict = None):
        self.conditions = conditions or {}

    @property
    def empty(self) -> bool:
        return not self.conditions

    def parse_where_clause(self) -> Tuple[str, List]:
        """Return ``(where_clause, params)`` for SQLite."""
        if self.empty:
            return '', []
        return _sql_parsing(self.conditions)

    # ----- columnar predicate backend (device bitmask) -----

    def compile_predicate(self):
        """Return ``fn(columns: Dict[str, np.ndarray]) -> np.ndarray[bool]``.

        Applied to columnar tag arrays; the resulting mask is fused into the
        device scoring kernel (exact replacement for the reference's
        probabilistic fuse filter, `bindings/hnsw_bindings.cpp:427-448`).
        """
        cond = self.conditions

        def fn(columns: Dict[str, np.ndarray]) -> np.ndarray:
            return _eval_predicate(cond, columns)

        return fn

    def __call__(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        return _eval_predicate(self.conditions, columns)


def _eval_predicate(condition: Dict, columns: Dict[str, np.ndarray]) -> np.ndarray:
    n = None
    for v in columns.values():
        n = len(v)
        break
    if not condition:
        return np.ones(n if n is not None else 0, dtype=bool)
    masks = []
    for key, value in condition.items():
        if key in LOGICAL_OPERATORS:
            if not isinstance(value, list):
                raise ValueError(f'The value of operator `{key}` must be a list')
            subs = [_eval_predicate(c, columns) for c in value]
            acc = subs[0]
            for s in subs[1:]:
                acc = (acc & s) if key == '$and' else (acc | s)
            masks.append(acc)
        elif key.startswith('$'):
            raise ValueError(f'The operator `{key}` is not supported')
        else:
            if key not in columns:
                raise ValueError(f'Unknown filterable column `{key}`')
            col = columns[key]
            if not isinstance(value, dict):
                value = {'$eq': value}
            for op, operand in value.items():
                if op == '$lt':
                    masks.append(col < operand)
                elif op == '$gt':
                    masks.append(col > operand)
                elif op == '$lte':
                    masks.append(col <= operand)
                elif op == '$gte':
                    masks.append(col >= operand)
                elif op == '$eq':
                    masks.append(col == operand)
                elif op in ('$neq', '$ne'):
                    masks.append(col != operand)
                elif op == '$in':
                    if not isinstance(operand, (list, tuple)):
                        raise ValueError(f'The value of operator `{op}` must be a list')
                    masks.append(np.isin(col, operand))
                elif op == '$nin':
                    if not isinstance(operand, (list, tuple)):
                        raise ValueError(f'The value of operator `{op}` must be a list')
                    masks.append(~np.isin(col, operand))
                else:
                    raise ValueError(f'The operator `{op}` is not supported')
    acc = masks[0]
    for m in masks[1:]:
        acc = acc & m
    return acc
