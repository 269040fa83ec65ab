"""Click feedback: served predictions become labeled training examples
(copy of ``repro/serving/feedback.py``; numpy only).

The online-learning loop of the paper (§1: models must be updated in
real-time, trained and served against the same embedding state) needs a
ground truth to click against. :class:`ClickModel` samples Bernoulli
clicks from the SAME planted logistic model that labels the offline
stream (``CTRDataset.truth()``), so the trainer consuming served feedback
chases the identical target as one reading the offline sampler — the
closed loop is then a pure systems question, not a distribution shift.

:class:`FeedbackQueue` is the serve -> train conduit: serving threads
``put`` labeled examples, the trainer thread ``next_batch``-es fixed-size
training batches off the other end.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np

from repro_torch.data.ctr import CTRDataset, PlantedTruth


class ClickModel:
    """Seeded, thread-safe Bernoulli clicks from a planted logistic truth.

    Deterministic as a *sequence*: the i-th label drawn through one
    ClickModel is reproducible, whichever thread draws it (the rng is
    guarded, the draw order is the arrival order)."""

    def __init__(self, truth: PlantedTruth, seed: int = 0):
        self.truth = truth
        self._rng = np.random.default_rng((seed, 17))
        self._lock = threading.Lock()

    @staticmethod
    def for_dataset(ds: CTRDataset, seed: int | None = None) -> "ClickModel":
        return ClickModel(ds.truth(), ds.seed if seed is None else seed)

    def prob(self, ids: np.ndarray, dense: np.ndarray | None = None
             ) -> np.ndarray:
        """(B, n_tasks) true click probabilities for batched requests."""
        return self.truth.prob(ids, dense)

    def click(self, request: dict) -> np.ndarray:
        """Label ONE served request — (n_tasks,) float32 in {0, 1}."""
        ids = np.asarray(request["ids"], np.int64)[None]
        dense = request.get("dense")
        p = self.truth.prob(ids, None if dense is None
                            else np.asarray(dense, np.float32)[None])[0]
        with self._lock:
            u = self._rng.random(p.shape)
        return (u < p).astype(np.float32)


class FeedbackQueue:
    """Bounded conduit of labeled examples from serving into training.

    Serving side: ``put(request, label)`` per served impression (oldest
    examples are dropped once ``capacity`` is exceeded — online learning
    trains on the freshest feedback, backlog is stale by definition).
    Trainer side: ``next_batch(timeout)`` blocks for a full batch in
    sampler format ({ids, labels[, dense]}) or returns None on timeout.
    """

    def __init__(self, batch_size: int, *, capacity: int | None = None):
        self.batch_size = int(batch_size)
        self.capacity = int(capacity) if capacity else 64 * self.batch_size
        self._cond = threading.Condition()
        self._buf: deque = deque(maxlen=self.capacity)
        self._put = 0
        self._dropped = 0
        self._closed = False

    def put(self, request: dict, label: np.ndarray):
        """Enqueue one labeled impression."""
        with self._cond:
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append((request, np.asarray(label, np.float32)))
            self._put += 1
            if len(self._buf) >= self.batch_size:
                self._cond.notify_all()

    def put_many(self, requests, labels):
        for req, lab in zip(requests, labels):
            self.put(req, lab)

    def close(self):
        """Wake any blocked trainer; subsequent next_batch drains then
        returns None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._buf)

    @property
    def stats(self) -> dict:
        with self._cond:
            return {"put": self._put, "dropped": self._dropped,
                    "pending": len(self._buf)}

    def next_batch(self, timeout: float | None = 1.0) -> dict | None:
        """Pop ``batch_size`` examples as one training batch, blocking up
        to ``timeout`` seconds for enough feedback; None if starved."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: len(self._buf) >= self.batch_size
                    or self._closed, timeout=timeout):
                return None
            if len(self._buf) < self.batch_size:
                return None
            pairs = [self._buf.popleft() for _ in range(self.batch_size)]
        ids = np.stack([np.asarray(r["ids"], np.int32) for r, _ in pairs])
        labels = np.stack([lab for _, lab in pairs])
        batch = {"ids": ids, "labels": labels.astype(np.float32)}
        if "dense" in pairs[0][0]:
            batch["dense"] = np.stack(
                [np.asarray(r["dense"], np.float32) for r, _ in pairs])
        return batch
