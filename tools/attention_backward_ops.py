#!/usr/bin/env python3
"""Operations that the attention's plain-torch backward
(``models/flash.py::flash_attention_bwd``) dispatches at an LM's attention
shapes, and their sum over one training step of the model: the host work
a step spends there, one device kernel or more per operation on the card.
View operations (slices, views, permutes, expands) launch nothing and are
not counted. The count depends only on Sq, Sk, the mask and the tile
(``flash.Q_BLOCK`` x ``flash.K_BLOCK``), not on B, the heads or Dh, so it
runs on the CPU at one head of 8:

    PYTHONPATH=src python3 tools/attention_backward_ops.py [--arch ARCH]
        [--seq 2048]

For whisper_medium: the encoder's self-attention (frames x frames,
non-causal), the decoder's causal self-attention (seq x seq) and its
cross-attention (seq x frames, non-causal), each once per layer; for a
decoder-only model its causal self-attention per attention layer. Prints
one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import flash  # noqa: E402

VIEWS = {"slice", "view", "_unsafe_view", "expand", "t", "transpose",
         "permute", "unsqueeze", "squeeze", "select", "detach", "alias",
         "as_strided", "_reshape_alias", "reshape", "lift_fresh"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def backward_ops(Sq: int, Sk: int, causal: bool) -> int:
    """Non-view operations of one ``flash_attention_bwd`` call."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1, s, 8), generator=gen)
               for s in (Sq, Sk, Sk))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, 0.35, causal)
    with _Ops() as mode:
        flash.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o), 0.35,
                                  causal)
    return sum(n for name, n in mode.ops.items() if name not in VIEWS)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper_medium")
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    S = args.seq
    shapes = {}
    if cfg.is_encdec:
        M, e = cfg.encoder.n_memory_tokens, cfg.encoder
        shapes["encoder"] = ((M, M, False), e.n_layers)
    n_self = sum(b.mixer in ("gqa", "mla") for b in cfg.prologue) + \
        sum(b.mixer in ("gqa", "mla") for b in cfg.pattern) * \
        cfg.pattern_repeats
    n_cross = sum(b.mixer == "cross_attn" or b.cross
                  for b in cfg.pattern) * cfg.pattern_repeats
    shapes["self"] = ((S, S, True), n_self)
    if n_cross:
        M = cfg.encoder.n_memory_tokens if cfg.is_encdec \
            else cfg.n_memory_tokens
        shapes["cross"] = ((S, M, False), n_cross)
    per_call = {name: backward_ops(*shape)
                for name, (shape, _) in shapes.items()}
    out = {"arch": cfg.name, "seq": S,
           "tile": [flash.Q_BLOCK, flash.K_BLOCK],
           "shapes": {name: {"Sq_Sk_causal": list(shape), "layers": n,
                             "ops_a_call": per_call[name]}
                      for name, (shape, n) in shapes.items()},
           "ops_a_step": sum(per_call[name] * n
                             for name, (_, n) in shapes.items())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
