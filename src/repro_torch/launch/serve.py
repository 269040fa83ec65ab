"""Batched LM serving driver (port of ``repro/launch/serve.py``): prefill a
batch of prompts, then decode tokens step by step against the per-layer KV
caches. The vocab table lives in an embedding backend (``dense``,
``host_lru`` or ``host_lru+disk``, optionally behind ``+compressed``, over
``--emb-shards`` shards of the sharded router);
each step prepares its tokens there (a host_lru table faults them into its
device cache before the prefill and before each decode step), looks them
up and runs the transformer on the activations. Every prefill attention
goes through the ``flash_attention_fwd`` CUDA kernel on the card, MLA's
(DeepSeek-V2: a 192-wide query/key head, a 128-wide value head) and
Jamba's GQA layer too; a Mamba-2 layer prefills by the chunked SSD and
decodes against its fixed-size state. A model with cross-attention
(llama-3.2-vision's gated layers over image patches, whisper's decoder
over its encoder's output) reads a memory drawn as the JAX package's
serve draws it, random normal x 0.1 from the prompts' stream (both
frontends are stubs): whisper's 1,500 frames of 1,024 go through its
encoder in the prefill, and the cross-attentions' K/V are cached there.

Usage (on the card; ``--device cpu`` runs the plain versions; ``--arch``
any of ``configs.ARCH_IDS``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --full --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek_v2_lite_16b --full --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_1_3b \\
      --full --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_medium \\
      --full --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama_3_2_vision_90b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.backend import create_backend
from repro_torch.device import resolve_device
from repro_torch.launch.shards import build_embedding_spec
from repro_torch.models import transformer as T

VOCAB_TABLE = "vocab"      # serve's sole table name in --emb-shards pairs


def memory_shape(cfg, batch: int) -> tuple | None:
    """(batch, M, d_memory) of the memory the model's cross-attentions
    read: an encoder-decoder's frames, else ``n_memory_tokens`` patches;
    None without a memory."""
    if cfg.is_encdec:
        return (batch, cfg.encoder.n_memory_tokens, cfg.encoder.d_memory)
    if cfg.n_memory_tokens:
        return (batch, cfg.n_memory_tokens, cfg.d_memory)
    return None


def make_inputs(cfg, batch: int, prompt_len: int, seed: int):
    """The JAX package's serve inputs from one ``default_rng(seed)``: the
    (batch, prompt_len) int32 prompts, then the memory (random normal x
    0.1, fp32; None without one)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    shape = memory_shape(cfg, batch)
    memory = None if shape is None else \
        (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return prompts, memory


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(batch, prompt_len) int32 token ids: the JAX package's prompts."""
    return make_inputs(cfg, batch, prompt_len, seed)[0]


def prefill_step(cfg, backend, emb, dense, prompts: torch.Tensor,
                 max_len: int, memory=None):
    """Look the prompts up and prefill (over ``memory``, if the model
    reads one): ``(emb, last-token logits (B, 1, padded_vocab) fp32,
    caches)``."""
    emb, dev_ids = backend.prepare(emb, prompts)
    acts, _ = backend.lookup(emb, dev_ids)
    logits, caches = T.prefill(cfg, dense, acts, memory, max_len=max_len)
    return emb, logits, caches


def decode_token(cfg, backend, emb, dense, tok: torch.Tensor, caches):
    """Look the (B, 1) tokens up and decode one step: ``(emb, logits (B,
    vocab_size) fp32, caches)``; the caches are updated in place."""
    emb, dev_ids = backend.prepare(emb, tok)
    acts, _ = backend.lookup(emb, dev_ids)
    logits, caches = T.decode_step(cfg, dense, acts, caches)
    return emb, logits[:, 0, :cfg.vocab_size], caches


def _next(logits: torch.Tensor, temperature: float,
          generator: torch.Generator) -> torch.Tensor:
    """(B, vocab) -> (B, 1) int32: greedy, or a draw from softmax(logits /
    temperature) (a torch stream: it cannot match ``jax.random``)."""
    if temperature > 0:
        p = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(p, 1, generator=generator).int()
    return torch.argmax(logits, dim=-1)[:, None].int()


def serve(cfg, batch=4, prompt_len=32, gen=16, seed=0, temperature=0.0,
          emb_backend="dense", cache_rows=0, emb_shards=1, *,
          device="cuda", state=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens (greedy unless ``temperature`` > 0). The weights and
    the vocab table are random from ``seed`` (the memory, if the model
    reads one, too: :func:`make_inputs`), or ``state=(emb_state,
    dense_params)`` (e.g. a JAX state through ``repro_torch.convert``; a
    host_lru table's state is its checkpoint blob, loaded into the
    backend built here).
    Returns the JAX package's keys: ``tokens`` (batch, gen) int32,
    ``prefill_s``, ``decode_s`` (host wall, ended by a synchronize) and
    ``decode_tok_per_s``."""
    dev = resolve_device(device)
    spec = build_embedding_spec(cfg.vocab_size, cfg.d_model,
                                backend=emb_backend, cache_rows=cache_rows,
                                emb_shards=emb_shards, table=VOCAB_TABLE)
    backend = create_backend(spec)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if state is None:
        dense = T.init_dense(cfg, generator)
        emb = backend.init(generator)
    else:
        emb, dense = state
        if "store" in emb or "shard_meta" in emb:
            from repro_torch.convert import table_from_numpy
            emb = table_from_numpy(backend, emb, dev)
    prompts, memory = make_inputs(cfg, batch, prompt_len, seed)
    prompts = torch.as_tensor(prompts, device=dev)
    if memory is not None:
        memory = torch.as_tensor(memory, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    emb, logits, caches = prefill_step(cfg, backend, emb, dense, prompts,
                                       prompt_len + gen, memory)
    tok = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)[:, None].int()
    sync()
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        emb, logits, caches = decode_token(cfg, backend, emb, dense, tok,
                                           caches)
        tok = _next(logits, temperature, generator)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t1
    return {
        "tokens": torch.cat(out, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--emb-backend", default="dense",
                    choices=["dense", "host_lru", "host_lru+disk",
                             "dense+compressed", "host_lru+compressed",
                             "host_lru+disk+compressed"],
                    help="vocab-table storage backend")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="host_lru device-cache slots (0 = vocab/8)")
    ap.add_argument("--emb-shards", default="1",
                    help="embedding-PS shards for the vocab table (a bare "
                         "int or 'vocab=k')")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args()
    cfg = get_config(args.arch, reduced=args.reduced)
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                temperature=args.temperature,
                emb_backend=args.emb_backend, cache_rows=args.cache_rows,
                emb_shards=args.emb_shards, device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill {res['prefill_s']:.2f}s decode {res['decode_s']:.2f}s "
          f"({res['decode_tok_per_s']:.1f} tok/s)")
    print("first sample tokens:", res["tokens"][0][:12])


if __name__ == "__main__":
    main()
