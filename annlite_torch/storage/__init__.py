from .kv import DocStorage
from .table import CellTable, MetaTable, Table

__all__ = ['DocStorage', 'CellTable', 'MetaTable', 'Table']
