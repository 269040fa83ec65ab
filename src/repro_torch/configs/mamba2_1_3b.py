"""Mamba2-1.3B [arXiv:2405.21060]. Attention-free SSD: 48 layers,
d_model 2048, state 128, head_dim 64 (d_inner 4096 -> 64 heads), vocab
50280. No FFN (the SSD mixer is the whole block, as in the paper). (Copy of
``repro/configs/mamba2_1_3b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    pattern=(BlockCfg("mamba2", "none"),),
    pattern_repeats=48,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    emb_staleness=1,
)
