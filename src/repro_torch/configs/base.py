"""Config schema for every architecture the framework can instantiate.

A model is described as an embedding front-end plus a *block program*: a short
pattern of heterogeneous blocks repeated ``pattern_repeats`` times (so the
whole stack lowers as one ``lax.scan`` over stacked parameters — essential to
keep HLO size bounded for 60..100-layer dry-runs), optionally preceded by a
few unscanned prologue blocks (e.g. DeepSeek's first dense FFN layer).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Mixer = Literal["gqa", "mla", "mamba2", "cross_attn", "none"]
Ffn = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class BlockCfg:
    """One block = mixer (attention / SSM / cross-attn) + FFN.

    ``cross=True`` adds a cross-attention sub-block after the mixer (Whisper
    decoder layers: self-attn + cross-attn + FFN)."""
    mixer: Mixer = "gqa"
    ffn: Ffn = "dense"
    cross: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio | recsys
    source: str = ""                   # citation for the config

    # Core dims -------------------------------------------------------------
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0                  # 0 -> d_model // n_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    max_seq_len: int = 1 << 20

    # Block program ----------------------------------------------------------
    pattern: tuple[BlockCfg, ...] = (BlockCfg(),)
    pattern_repeats: int = 2
    prologue: tuple[BlockCfg, ...] = ()   # unscanned leading blocks

    # Attention --------------------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0            # 0 = full attention; >0 = window size
    attn_logit_softcap: float = 0.0

    # MLA (DeepSeek-V2) -------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0               # 0 -> direct q projection
    rope_head_dim: int = 64
    v_head_dim: int = 0                # 0 -> head_dim

    # MoE ---------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    router_z_weight: float = 1e-3

    # SSM (Mamba-2 / SSD) ------------------------------------------------------
    ssm_state: int = 0                 # N (state dim per head)
    ssm_head_dim: int = 64             # P
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 256               # SSD chunk length

    # Cross-attention (VLM) / encoder-decoder (audio) ---------------------------
    n_memory_tokens: int = 0           # image patches / encoder frames
    d_memory: int = 0                  # 0 -> d_model
    encoder: Optional["ModelConfig"] = None   # for enc-dec (whisper)

    # Activation / norm ----------------------------------------------------------
    ffn_act: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_dtype: str = "float32"

    # RecSys (paper's own family) ---------------------------------------------
    # When arch_type == "recsys", the model is an embedding-bag DLRM/FFNN.
    n_id_fields: int = 0               # number of ID-type feature fields
    ids_per_field: int = 8             # multi-hot width per field
    emb_dim: int = 128                 # embedding vector dim (paper: 128)
    emb_rows: int = 0                  # total embedding rows across fields
    n_dense_features: int = 0          # Non-ID features
    mlp_dims: tuple[int, ...] = (4096, 2048, 1024, 512, 256)   # paper's FFNN
    n_tasks: int = 1

    # Persia hybrid-training knobs ----------------------------------------------
    emb_staleness: int = 0             # tau: 0 = fully synchronous embeddings
    emb_optimizer: str = "adagrad"     # row-wise optimizer on the PS shards

    # Lowering knobs ---------------------------------------------------------------
    remat: bool = True                 # activation-checkpoint each scanned layer
    remat_granularity: str = "body"    # 'body' | 'block' (multi-block patterns)
    seq_shard: bool = True             # shard residual stream's seq dim over 'model'

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.d_memory == 0:
            object.__setattr__(self, "d_memory", self.d_model)

    # -- derived ---------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """LM-head vocab padded to a TP-friendly multiple (512 covers any
        model-axis width up to 512 and the 128-lane MXU tile)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def n_layers(self) -> int:
        return len(self.prologue) + len(self.pattern) * self.pattern_repeats

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def has_attention(self) -> bool:
        blocks = self.prologue + self.pattern
        return any(b.mixer in ("gqa", "mla", "cross_attn") for b in blocks)

    @property
    def subquadratic(self) -> bool:
        """True when a 500k-token decode is tractable (SSM-only or windowed)."""
        blocks = self.prologue + self.pattern
        full_attn = any(b.mixer in ("gqa", "mla") for b in blocks)
        return (not full_attn) or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 scanned layers, d_model<=512, <=4 experts.
        The reduced pattern keeps one block of each distinct kind so every
        mixer/FFN type in the family is exercised."""
        seen, pat = set(), []
        for b in self.pattern:
            key = (b.mixer, b.ffn, b.cross)
            if key not in seen:
                seen.add(key)
                pat.append(b)
            if len(pat) == 3:
                break
        kw: dict = dict(
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            pattern_repeats=1,
            pattern=tuple(pat),
            prologue=self.prologue[:1],
        )
        if self.n_experts:
            kw.update(n_experts=4, moe_top_k=min(self.moe_top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_d_ff=min(self.moe_d_ff or self.d_ff, 256))
        if self.kv_lora_rank:
            kw.update(kv_lora_rank=64, q_lora_rank=min(self.q_lora_rank, 64),
                      rope_head_dim=32, v_head_dim=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.n_memory_tokens:
            kw.update(n_memory_tokens=16)
        kw.update(d_memory=min(self.d_memory, 256))
        if self.encoder is not None:
            # decoder cross-attn consumes the (reduced) encoder's d_model
            enc = self.encoder.reduced()
            kw.update(encoder=enc, d_memory=enc.d_model)
        if self.arch_type == "recsys":
            kw.update(n_id_fields=min(self.n_id_fields, 4), emb_dim=16,
                      emb_rows=min(self.emb_rows, 1024),
                      mlp_dims=(64, 32), n_dense_features=min(self.n_dense_features, 4))
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["training", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "training"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
