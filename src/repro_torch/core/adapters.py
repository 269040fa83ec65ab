"""ModelAdapter constructors (port of ``repro/core/adapters.py``): recsys
(the paper's family: one embedding table per ID feature field, the
heterogeneous feature groups of Table 1, pooled bags into the FFNN) and LM
(a one-table collection over the vocabulary, whose loss takes the tokens'
activations unpooled).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collection import EmbeddingCollection
from repro_torch.core.embedding_ps import EmbeddingSpec
from repro_torch.core.hybrid import ModelAdapter
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.utils import default_field_rows


def field_table_name(i: int) -> str:
    return f"field_{i:02d}"


def ctr_collection(cfg, *, lr=1e-2, dtype=torch.float32,
                   field_rows=None) -> EmbeddingCollection:
    """Per-field tables from a recsys ModelConfig: ``cfg.emb_rows`` total
    rows split evenly over ``cfg.n_id_fields`` fields (matching
    ``CTRDataset``'s per-field id spaces), each its own full-mode table."""
    F = cfg.n_id_fields
    if field_rows is None:
        field_rows = (default_field_rows(cfg.emb_rows, F),) * F
    if len(field_rows) != F:
        raise ValueError(f"{len(field_rows)} field_rows for {F} fields")
    return EmbeddingCollection.from_dict({
        field_table_name(i): EmbeddingSpec(
            rows=int(r), dim=cfg.emb_dim, mode="full",
            optimizer=cfg.emb_optimizer, lr=lr,
            staleness=cfg.emb_staleness, dtype=dtype)
        for i, r in enumerate(field_rows)})


def recsys_adapter(cfg, *, lr=1e-2, dtype=torch.float32, field_rows=None,
                   collection: EmbeddingCollection | None = None
                   ) -> ModelAdapter:
    """Multi-table CTR adapter. ``batch["ids"]`` is (B, F, L) with
    *per-field local* ids; field i maps to the collection's i-th table.
    ``loss`` and ``predict`` take the pooled (B, D) bags of
    ``PersiaTrainer.serve_lookup``."""
    coll = collection if collection is not None \
        else ctr_collection(cfg, lr=lr, dtype=dtype, field_rows=field_rows)
    names = coll.names
    if len(names) != cfg.n_id_fields:
        raise ValueError(f"{len(names)} tables for {cfg.n_id_fields} fields")
    d_in = sum(spec.dim for _, spec in coll.items()) + cfg.n_dense_features

    def emb_ids(b):
        return {n: b["ids"][:, i] for i, n in enumerate(names)}

    def loss(dense, pooled, b):
        return R.recsys_loss_pooled(cfg, dense, pooled, b)

    def predict(dense, pooled, b):
        return torch.sigmoid(R.recsys_forward_pooled(
            cfg, dense, pooled, b.get("dense")).float())

    return ModelAdapter(
        cfg=cfg,
        collection=coll,
        init_dense=lambda gen: R.recsys_init(cfg, gen, dtype, d_in=d_in),
        emb_ids=emb_ids,
        loss=loss,
        predict=predict,
    )


def lm_adapter(cfg, *, lr=1e-2, dtype=torch.float32) -> ModelAdapter:
    """One ``"vocab"`` table (model mode, the config's row optimizer and
    staleness); ``emb_ids`` are the batch's tokens and ``loss`` is
    :func:`~repro_torch.models.transformer.lm_loss` on their occurrence
    activations (``pooled=False``). Under a mesh the dense stack is
    tensor-parallel and ZeRO sharded (``dense_specs``: the stage of
    ``REPRO_ZERO_STAGE``, 3 by default; ``stage=3`` gives the Adam
    moments' specs)."""
    from repro_torch.models import tp as TP
    coll = EmbeddingCollection.single("vocab", EmbeddingSpec(
        rows=cfg.vocab_size, dim=cfg.d_model, mode="model",
        optimizer=cfg.emb_optimizer, lr=lr,
        staleness=cfg.emb_staleness, dtype=dtype))

    def loss(dense, acts, b):
        return T.lm_loss(cfg, dense, acts["vocab"], b["targets"], b["mask"],
                         b.get("memory"))

    return ModelAdapter(
        cfg=cfg,
        collection=coll,
        init_dense=lambda gen: T.init_dense(cfg, gen, dtype),
        emb_ids=lambda b: {"vocab": b["tokens"]},
        loss=loss,
        pooled=False,
        dense_specs=lambda mesh, stage=None: TP.dense_specs(cfg, mesh,
                                                            stage),
    )


# ---------------------------------------------------------------------------
# AUC (host-side, exact via rank statistic; copied numpy)
# ---------------------------------------------------------------------------

def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC; labels/scores flat float arrays."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks for ties
    s_sorted = scores[order]
    ranks[order] = np.arange(1, len(scores) + 1)
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
