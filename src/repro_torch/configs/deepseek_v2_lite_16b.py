"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]. MLA (kv_lora=512, no q-lora,
rope_head_dim=64), 27 layers (first FFN dense, rest MoE 64 routed top-6 +
2 shared, expert hidden 1408), d_model 2048, 16 heads, vocab 102400. (Copy of
``repro/configs/deepseek_v2_lite_16b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,                 # qk_nope_head_dim
    d_ff=10944,                   # first dense layer's FFN
    vocab_size=102_400,
    prologue=(BlockCfg("mla", "dense"),),
    pattern=(BlockCfg("mla", "moe"),),
    pattern_repeats=26,
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    rope_theta=10_000.0,
    emb_staleness=1,
)
