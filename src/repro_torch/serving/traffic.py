"""Power-law serving traffic: a simulated million-user id distribution.

The paper's motivating deployments serve live recommendation traffic whose
id popularity is sharply Zipfian (§2: the alpha << 1 access-skew regime
that makes caching/staleness tractable at all). This module replays that
shape: each request is drawn from a fixed population of ``n_users``
synthetic users, user popularity follows the same bounded inverse-CDF Zipf
the offline sampler uses, and each user has a deterministic feature
profile — so a hot user hits the same embedding rows on every visit and
the serve-path cache/staleness metrics mean what they would in production.

``TrafficGenerator`` turns the request stream into timed arrivals at a
configurable QPS with multiplicative jitter, for open-loop latency runs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.data.ctr import CTRDataset


def zipf_ranks(u: np.ndarray, n: int, a: float) -> np.ndarray:
    """Bounded Zipf(a) over [0, n) via the same rejection-free inverse-CDF
    approximation as ``CTRDataset.sampler`` — uniform draws ``u`` in [0,1)
    map to ranks, rank 0 hottest."""
    ranks = np.floor(((n ** (1 - a) - 1) * u + 1) ** (1 / (1 - a)) - 1)
    return np.clip(ranks, 0, n - 1).astype(np.int64)


@dataclass(frozen=True)
class TrafficModel:
    """Deterministic user-population model over a dataset's feature space.

    A user id fully determines the request: ``request_for(uid)`` seeds a
    per-user rng with ``(seed, uid)``, so replaying a uid replays its ids
    and dense features bit-for-bit. The *sequence* of uids is the Zipf
    draw — hot users recur, cold users are near-singletons.
    """

    n_fields: int
    ids_per_field: int
    rows_per_field: int
    n_dense: int
    n_users: int = 1_000_000
    zipf_a: float = 1.2
    seed: int = 0

    @staticmethod
    def for_dataset(ds: CTRDataset, n_users: int = 1_000_000,
                    seed: int | None = None) -> "TrafficModel":
        return TrafficModel(
            n_fields=ds.n_fields, ids_per_field=ds.ids_per_field,
            rows_per_field=ds.rows_per_field, n_dense=ds.n_dense,
            n_users=n_users, zipf_a=ds.zipf_a,
            seed=ds.seed if seed is None else seed)

    def user_ids(self, n: int, *, seed: int = 0) -> np.ndarray:
        """Draw ``n`` visiting users — Zipf over the population, so a few
        user ids dominate (the serving hot set)."""
        rng = np.random.default_rng((self.seed, seed))
        return zipf_ranks(rng.random(n), self.n_users, self.zipf_a)

    def request_for(self, uid: int) -> dict:
        """The user's deterministic feature profile: ``ids`` of shape
        (n_fields, ids_per_field) with -1 multi-hot padding, plus
        ``dense`` (n_dense,) when the dataset has dense features."""
        rng = np.random.default_rng((self.seed, int(uid)))
        # the user's ids are themselves Zipf within each field's table, so
        # hot users and hot rows compound the way production logs do
        ids = zipf_ranks(rng.random((self.n_fields, self.ids_per_field)),
                         self.rows_per_field, self.zipf_a)
        lens = rng.integers(1, self.ids_per_field + 1, self.n_fields)
        mask = np.arange(self.ids_per_field)[None, :] < lens[:, None]
        req = {"ids": np.where(mask, ids, -1).astype(np.int32)}
        if self.n_dense:
            req["dense"] = rng.standard_normal(self.n_dense) \
                .astype(np.float32)
        return req

    def requests(self, n: int, *, seed: int = 0):
        """``n`` (uid, request) pairs in visit order — deterministic in
        (model seed, stream seed)."""
        for uid in self.user_ids(n, seed=seed):
            yield int(uid), self.request_for(int(uid))


@dataclass(frozen=True)
class TrafficGenerator:
    """Open-loop arrival process: target ``qps`` with multiplicative
    ``jitter`` on each inter-arrival gap (0 = strict pacing, 1 = gaps
    uniform in [0, 2/qps))."""

    model: TrafficModel
    qps: float = 200.0
    jitter: float = 0.5
    seed: int = 0

    def arrivals(self, n: int):
        """``n`` (t_offset_s, uid, request) tuples; offsets start at 0 and
        are non-decreasing."""
        rng = np.random.default_rng((self.seed, 1))
        gap = 1.0 / max(self.qps, 1e-9)
        scale = 1.0 + self.jitter * (2.0 * rng.random(n) - 1.0)
        t = np.concatenate([[0.0], np.cumsum(gap * scale)[:-1]])
        for off, (uid, req) in zip(t, self.model.requests(n,
                                                          seed=self.seed)):
            yield float(off), uid, req

    def replay(self, n: int, submit, *, clock=time.monotonic,
               sleep=time.sleep):
        """Pace ``n`` requests in wall-clock time: sleeps to each arrival
        offset and calls ``submit(request)``; returns the submit results
        in arrival order. Falls behind gracefully (never sleeps a negative
        gap) so a slow service degrades to closed-loop."""
        t0 = clock()
        out = []
        for off, _uid, req in self.arrivals(n):
            lag = (t0 + off) - clock()
            if lag > 0:
                sleep(lag)
            out.append(submit(req))
        return out
