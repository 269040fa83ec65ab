"""Whisper-medium [arXiv:2212.04356]. Encoder-decoder, 24+24 layers,
d_model 1024, 16H, d_ff 4096, GELU, LayerNorm, learned positions, vocab
51865. The mel-spectrogram + conv frontend is a stub: input_specs provides
precomputed frame embeddings (B, 1500, 1024) — the encoder's post-conv
sequence for 30 s of audio. The port draws them as the JAX package's serve
does (``launch/serve.py``). (Copy of ``repro/configs/whisper_medium.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

_ENCODER = ModelConfig(
    name="whisper-medium-encoder",
    arch_type="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    pattern=(BlockCfg("gqa", "dense"),),
    pattern_repeats=24,
    ffn_act="gelu",
    norm="layernorm",
    n_memory_tokens=1500,
    d_memory=1024,
)

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    pattern=(BlockCfg("gqa", "dense", cross=True),),
    pattern_repeats=24,
    ffn_act="gelu",
    norm="layernorm",
    encoder=_ENCODER,
    emb_staleness=1,
)
