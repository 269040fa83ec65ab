"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision family scaled].
100 layers, d_model 8192, 64H/8kv, d_ff 28672, vocab 128256. Cross-attention
image layers interleaved 1-in-5 (tanh-gated, consuming stub-projected patch
embeddings — the ViT frontend is a stub per the modality carve-out). (Copy of
``repro/configs/llama_3_2_vision_90b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    pattern=(BlockCfg("gqa", "dense"),
             BlockCfg("gqa", "dense"),
             BlockCfg("gqa", "dense"),
             BlockCfg("gqa", "dense"),
             BlockCfg("cross_attn", "dense")),
    pattern_repeats=20,
    n_memory_tokens=1600,          # 4 tiles x 400 patches (stubbed)
    rope_theta=500_000.0,
    emb_staleness=1,
)
