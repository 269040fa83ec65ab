"""Small shared helpers: integer arithmetic (copied from ``repro/utils.py``)
and the nested dict/list walks that stand in for ``jax.tree``."""
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


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts and lists of the same
    structure (the parameter trees of the dense model and its optimizer).
    ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list tree, dict keys in sorted order (the
    order of ``jax.tree.leaves``, so sums over leaves add alike)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]
