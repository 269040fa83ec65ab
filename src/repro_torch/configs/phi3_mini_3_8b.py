"""Phi-3-mini 3.8B [arXiv:2404.14219]. Dense MHA (32H / 32 kv), RoPE,
SwiGLU, 32 layers, d_model 3072, d_ff 8192, vocab 32064. (Copy of
``repro/configs/phi3_mini_3_8b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    source="arXiv:2404.14219",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    pattern=(BlockCfg("gqa", "dense"),),
    pattern_repeats=32,
    rope_theta=10_000.0,
    emb_staleness=1,
)
