"""The paper's own model family (port of ``repro/models/recsys.py``):
multi-hot embedding bags + FFNN (§6 "a fully connected feed forward neural
network with five hidden layers 4096-2048-1024-512-256"), predicting one or
more CTR/behaviour tasks.

Parameters are a plain dict ``{"mlp": [{"w": (d_in, d_out), "b":
(d_out,)}, ...]}`` in the JAX package's layout, so weights carry across
unchanged (``repro_torch.convert``). The serving forward takes the bags
already pooled by the embedding read (``backend.read_pooled_all``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init


def recsys_init(cfg, generator: torch.Generator, dtype=torch.float32,
                d_in: int | None = None) -> dict:
    """d_in overrides the pooled-embedding input width (heterogeneous
    per-table dims sum to something other than n_id_fields * emb_dim)."""
    if d_in is None:
        d_in = cfg.n_id_fields * cfg.emb_dim + cfg.n_dense_features
    dims = (d_in,) + tuple(cfg.mlp_dims) + (cfg.n_tasks,)
    layers = []
    for i in range(len(dims) - 1):
        layers.append({
            "w": dense_init(generator, dims[i], dims[i + 1], dtype,
                            scale=math.sqrt(2.0 / dims[i])),
            "b": torch.zeros((dims[i + 1],), dtype=dtype,
                             device=generator.device),
        })
    return {"mlp": layers}


def pool_bag(acts: torch.Tensor, ids) -> torch.Tensor:
    """Sum-pool one table's multi-hot bag: (B, L, D), (B, L) -> (B, D);
    padding ids (< 0) contribute zero."""
    ids = torch.as_tensor(ids, device=acts.device)
    m = (ids >= 0).to(acts.dtype)[..., None]
    return torch.sum(acts * m, dim=1)


def _mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(params["mlp"])
    for i, lyr in enumerate(params["mlp"]):
        x = x @ lyr["w"] + lyr["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def recsys_forward_pooled(cfg, params: dict, pooled: dict, dense_feats
                          ) -> torch.Tensor:
    """Multi-table forward from pooled bags: ``pooled`` {name: (B, D_t)}
    concatenated in SORTED table-name order (the JAX package's order: its
    dict pytrees are key-sorted across jit boundaries), Non-ID features
    appended, then the shared FFNN -> (B, n_tasks) logits."""
    x = torch.cat([pooled[n] for n in sorted(pooled)], dim=-1)
    if cfg.n_dense_features:
        x = torch.cat([x, torch.as_tensor(dense_feats, dtype=x.dtype,
                                          device=x.device)], dim=-1)
    return _mlp(params, x)


def recsys_loss_pooled(cfg, params: dict, pooled: dict, batch: dict):
    """Binary cross-entropy per task (CTR-style) from pooled bags."""
    logits = recsys_forward_pooled(cfg, params, pooled, batch.get("dense"))
    return _bce_loss(logits, batch)


def _bce_loss(logits: torch.Tensor, batch: dict):
    z = logits.float()
    y = torch.as_tensor(batch["labels"], dtype=torch.float32, device=z.device)
    # stable BCE-with-logits
    nll = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    loss = nll.mean()
    metrics = {"loss": loss, "pred_mean": torch.sigmoid(z).mean()}
    return loss, metrics
