"""Shared spec plumbing for the launchers (copy of ``repro/launch/
shards.py``): one ``--emb-shards`` grammar (a bare int or comma-separated
``table=k`` pairs), one way to build an EmbeddingSpec from CLI knobs and
one way to apply a backend choice to a collection. A table of more than
one shard runs through the sharded router (``core/backend.py``
``ShardedBackend``).
"""
from __future__ import annotations


def parse_emb_shards(s: str | int | None):
    """``--emb-shards`` value -> int or {table: k} mapping. Accepts a bare
    int ("4") or comma-separated ``table=k`` pairs ("field_00=4,field_02=2");
    table names are validated downstream against the collection."""
    if isinstance(s, int):
        return s
    s = (s or "1").strip()
    if "=" not in s:
        return int(s)
    out = {}
    for part in s.split(","):
        name, _, k = part.partition("=")
        if not name.strip() or not k.strip():
            raise ValueError(
                f"bad --emb-shards entry {part!r}: expected 'table=k'")
        out[name.strip()] = int(k)
    return out


def shards_for_table(shards, name: str, default: int = 1) -> int:
    """Resolve one table's shard count out of a parsed ``--emb-shards``
    value (single-table launchers like serve.py name their sole table and
    pick its entry; unknown names fall back to ``default``)."""
    if isinstance(shards, int):
        return shards
    return int(shards.get(name, default))


def default_cache_rows(rows: int, cache_rows: int = 0) -> int:
    """The launchers' host_lru device-cache sizing: explicit wins, else an
    eighth of the table (floored so tiny tables still cache something)."""
    return cache_rows or max(1024, rows // 8)


def build_embedding_spec(rows: int, dim: int, backend: str = "dense",
                         cache_rows: int = 0, emb_shards: "str | int" = 1,
                         table: str = "vocab", **spec_kw):
    """One table's EmbeddingSpec from the shared CLI knobs: resolves the
    ``--emb-shards`` grammar against ``table`` and fills the host_lru
    cache-size default. Extra keywords pass through to the spec."""
    import dataclasses

    from repro_torch.core.embedding_ps import EmbeddingSpec

    shards = shards_for_table(parse_emb_shards(emb_shards), table)
    spec = EmbeddingSpec(rows=rows, dim=dim, backend=backend,
                         emb_shards=max(int(shards), 1), **spec_kw)
    if backend.startswith("host_lru"):
        spec = dataclasses.replace(
            spec, cache_rows=default_cache_rows(rows, cache_rows))
    return spec


def apply_backend_choice(coll, backend: str, cache_rows: int | None = None):
    """Override a collection's storage backend from a CLI choice: host-
    backed variants carry the cache size, device-resident variants must
    NOT (dense has no cache; ``dense+compressed`` keeps each spec's own
    cache_rows), and plain ``dense`` is the specs' default."""
    if backend.partition("+")[0] != "dense":
        return coll.with_backend(backend, cache_rows)
    if backend != "dense":
        return coll.with_backend(backend, None)
    return coll
