"""DeepSeek-V2 236B [arXiv:2405.04434]. MLA (q_lora=1536, kv_lora=512),
60 layers (first FFN dense, rest MoE 160 routed top-6 + 2 shared, expert
hidden 1536), d_model 5120, 128 heads, vocab 102400. (Copy of
``repro/configs/deepseek_v2_236b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,
    vocab_size=102_400,
    prologue=(BlockCfg("mla", "dense"),),
    pattern=(BlockCfg("mla", "moe"),),
    pattern_repeats=59,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    rope_theta=10_000.0,
    emb_staleness=1,
)
