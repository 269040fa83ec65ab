"""Qwen3-14B [hf:Qwen/Qwen3-8B family]. Dense GQA (40H / 8 kv), qk-norm,
40 layers, d_model 5120, d_ff 17408, vocab 151936. (Copy of
``repro/configs/qwen3_14b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151_936,
    pattern=(BlockCfg("gqa", "dense"),),
    pattern_repeats=40,
    qk_norm=True,
    rope_theta=1_000_000.0,
    emb_staleness=1,
)
