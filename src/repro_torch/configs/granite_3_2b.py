"""Granite-3.0 2B [hf:ibm-granite/granite-3.0-2b-base]. Dense GQA
(32H / 8 kv), 40 layers, d_model 2048, d_ff 8192, vocab 49155. (Copy of
``repro/configs/granite_3_2b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    pattern=(BlockCfg("gqa", "dense"),),
    pattern_repeats=40,
    rope_theta=10_000.0,
    emb_staleness=1,
)
