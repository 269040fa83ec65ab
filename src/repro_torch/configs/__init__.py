"""Config schema, the paper's recsys configurations and the LM
architectures (copies of ``repro/configs``).

``get_config('<arch-id>')`` returns the exact configuration,
``get_config('<arch-id>', reduced=True)`` its smoke variant, as in the JAX
package. ``ARCH_IDS`` holds every architecture of the JAX package (the
dense GQA family, DeepSeek-V2's MLA + MoE, Mamba-2, the Jamba hybrid,
Llama-3.2-Vision's interleaved cross-attention and the Whisper
encoder-decoder); an unknown id raises ``ValueError``.
"""
import importlib

from repro_torch.configs.base import (BlockCfg, InputShape, INPUT_SHAPES,
                                      ModelConfig)
from repro_torch.configs.recsys_configs import (AVAZU, CRITEO, KWAI, TAOBAO,
                                                criteo_syn)

ARCH_IDS = ["deepseek_v2_lite_16b", "qwen3_14b", "deepseek_v2_236b",
            "phi3_mini_3_8b", "mamba2_1_3b", "llama_3_2_vision_90b",
            "deepseek_coder_33b", "jamba_v0_1_52b", "whisper_medium",
            "granite_3_2b"]
RECSYS_IDS = ["taobao_dlrm", "avazu_dlrm", "criteo_dlrm", "kwai_dlrm"]
_RECSYS = dict(zip(RECSYS_IDS, (TAOBAO, AVAZU, CRITEO, KWAI)))


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    name = canonical(name)
    if name in _RECSYS:
        cfg = _RECSYS[name]
    elif name in ARCH_IDS:
        cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    else:
        raise ValueError(f"unknown architecture {name!r}: the configs are "
                         f"{ARCH_IDS + RECSYS_IDS}")
    return cfg.reduced() if reduced else cfg
