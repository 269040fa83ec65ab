"""EmbeddingCollection — a registry of named embedding tables (port of the
registry part of ``repro/core/collection.py``).

Persia's production models (paper §4.1, Table 1) are built from many
heterogeneous ID feature groups; a collection maps table *names* to
independent :class:`~repro_torch.core.embedding_ps.EmbeddingSpec` s. The
trainer reaches tables through their backends and the fan-outs of
``core/backend.py`` (``prepare_all``, ``lookup_all``, ``put_all``); the JAX
package's collection-level wrappers of those are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Iterator, Mapping

from repro_torch.core.embedding_ps import EmbeddingSpec


@dataclass(frozen=True)
class EmbeddingCollection:
    """Ordered, immutable registry of named embedding tables."""

    tables: tuple[tuple[str, EmbeddingSpec], ...]

    def __post_init__(self):
        from repro_torch.core.backend import create_backend
        seen = set()
        for n, s in self.tables:
            # names key checkpoint blob paths in the JAX package: '/' would
            # split the path, and all-digit names read back as list indices
            if not n or "/" in n or n.isdigit():
                raise ValueError(
                    f"invalid table name {n!r}: names must be non-empty, "
                    "contain no '/', and not be all digits")
            if n in seen:
                raise ValueError(f"duplicate table name {n!r}")
            seen.add(n)
            create_backend(s)       # fail fast on bad or unported specs

    @staticmethod
    def from_dict(specs: Mapping[str, EmbeddingSpec]) -> "EmbeddingCollection":
        return EmbeddingCollection(tuple(specs.items()))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.tables)

    @property
    def specs(self) -> dict[str, EmbeddingSpec]:
        return dict(self.tables)

    def items(self):
        return self.tables

    def __len__(self) -> int:
        return len(self.tables)

    def __iter__(self) -> Iterator[str]:
        return iter(self.names)

    def __getitem__(self, name: str) -> EmbeddingSpec:
        for n, s in self.tables:
            if n == name:
                return s
        raise KeyError(name)

    def map_specs(self, fn: Callable[[str, EmbeddingSpec], EmbeddingSpec]
                  ) -> "EmbeddingCollection":
        return EmbeddingCollection(tuple((n, fn(n, s)) for n, s in self.tables))

    def with_staleness(self, tau: int) -> "EmbeddingCollection":
        """Set every table's staleness to ``tau`` (mode-wide override)."""
        return self.map_specs(
            lambda _, s: dataclasses.replace(s, staleness=tau))

    def with_backend(self, backend: str) -> "EmbeddingCollection":
        """Set every table's storage backend (collection-wide override),
        e.g. ``"dense+compressed"``."""
        return self.map_specs(
            lambda _, s: dataclasses.replace(s, backend=backend))

    def make_backends(self):
        """One EmbeddingBackend per table (core/backend.py)."""
        from repro_torch.core.backend import make_backends
        return make_backends(self)
