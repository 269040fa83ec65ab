"""Small shared integer helpers (copied from ``repro/utils.py``)."""
from __future__ import annotations


def default_field_rows(total_rows: int, n_fields: int) -> int:
    """Rows of each field's id space when one flat row budget is split
    evenly over fields — the single source of the formula shared by
    CTRDataset (id generation) and ctr_collection (table sizing)."""
    return max(total_rows // max(n_fields, 1), 4)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b
