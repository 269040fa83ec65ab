"""Stand-ins for every model input of the dry run (port of
``repro/launch/input_specs.py``): the JAX package's names, shapes and
dtypes, as tensors on the ``meta`` device (no memory, no data).

The token ids are the exception: the port builds its dedup plans on the
host from the ids themselves, so they are real int32 tensors on the CPU,
drawn from ``seed``. Under a mesh every rank's plan is padded to the dedup
cap, so no shape downstream depends on the draw.
"""
from __future__ import annotations

import numpy as np
import torch

META = torch.device("meta")


def _ids(shape, high: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, max(high, 1), shape,
                                         dtype=np.int32))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _memory(cfg, B: int, dtype):
    if cfg.is_encdec:
        e = cfg.encoder
        return _meta((B, e.n_memory_tokens, e.d_memory), dtype)
    if cfg.n_memory_tokens:
        return _meta((B, cfg.n_memory_tokens, cfg.d_memory), dtype)
    return None


def train_inputs(cfg, shape, compute_dtype=torch.float32,
                 seed: int = 0) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.arch_type == "recsys":
        b = {"ids": _ids((B, cfg.n_id_fields, cfg.ids_per_field),
                         cfg.emb_rows // max(cfg.n_id_fields, 1), seed),
             "labels": _meta((B, cfg.n_tasks), torch.float32)}
        if cfg.n_dense_features:
            b["dense"] = _meta((B, cfg.n_dense_features), torch.float32)
        return b
    b = {"tokens": _ids((B, S), cfg.vocab_size, seed),
         "targets": _meta((B, S), torch.int32),
         "mask": _meta((B, S), torch.float32)}
    mem = _memory(cfg, B, compute_dtype)
    if mem is not None:
        b["memory"] = mem
    return b


def prefill_inputs(cfg, shape, compute_dtype=torch.float32,
                   seed: int = 0) -> dict:
    B, S = shape.global_batch, shape.seq_len
    b = {"tokens": _ids((B, S), cfg.vocab_size, seed)}
    mem = _memory(cfg, B, compute_dtype)
    if mem is not None:
        b["memory"] = mem
    return b


def decode_inputs(cfg, shape, seed: int = 0) -> dict:
    B = shape.global_batch
    return {"tokens": _ids((B, 1), cfg.vocab_size, seed)}


def memory_len(cfg) -> int:
    if cfg.is_encdec:
        return cfg.encoder.n_memory_tokens
    return cfg.n_memory_tokens
