"""DeepSeek-Coder 33B [arXiv:2401.14196]. Llama-arch dense GQA (56H / 8 kv),
62 layers, d_model 7168, d_ff 19200, vocab 32256. (Copy of
``repro/configs/deepseek_coder_33b.py``.)"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    source="arXiv:2401.14196",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32_256,
    pattern=(BlockCfg("gqa", "dense"),),
    pattern_repeats=62,
    rope_theta=100_000.0,
    emb_staleness=1,
)
