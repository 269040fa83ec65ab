"""Jamba v0.1 52B [arXiv:2403.19887]. Hybrid Mamba+attention 7:1 interleave
(attention at position 4 of each 8-layer block), MoE 16 experts top-2 every
other layer. 32 layers, d_model 4096, 32H/8kv, d_ff 14336, vocab 65536.

Deviation: the SSM mixer is our Mamba-2/SSD implementation (state 128)
rather than Mamba-1 (state 16), as in the JAX package. (Copy of
``repro/configs/jamba_v0_1_52b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig


def _block(i: int) -> BlockCfg:
    mixer = "gqa" if i == 4 else "mamba2"
    ffn = "moe" if i % 2 == 1 else "dense"
    return BlockCfg(mixer, ffn)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    pattern=tuple(_block(i) for i in range(8)),
    pattern_repeats=4,
    n_experts=16,
    n_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=14336,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    rope_theta=10_000.0,
    emb_staleness=1,
)
