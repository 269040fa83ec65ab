"""Config schema, the paper's recsys configurations and the LM
architectures ported so far (copies of ``repro/configs``).

``get_config('<arch-id>')`` returns the exact configuration,
``get_config('<arch-id>', reduced=True)`` its smoke variant, as in the JAX
package. The port has the ids in ``ARCH_IDS`` (the dense GQA family,
DeepSeek-V2's MLA + MoE, Mamba-2 and the Jamba hybrid) and the recsys
ids; the other architectures of the JAX package (the vision and
encoder-decoder models) raise until their slice is ported.
"""
import importlib

from repro_torch.configs.base import (BlockCfg, InputShape, INPUT_SHAPES,
                                      ModelConfig)
from repro_torch.configs.recsys_configs import (AVAZU, CRITEO, KWAI, TAOBAO,
                                                criteo_syn)

ARCH_IDS = ["deepseek_v2_lite_16b", "qwen3_14b", "deepseek_v2_236b",
            "phi3_mini_3_8b", "deepseek_coder_33b", "granite_3_2b",
            "mamba2_1_3b", "jamba_v0_1_52b"]
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
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: the torch port has "
            f"{ARCH_IDS + RECSYS_IDS}")
    return cfg.reduced() if reduced else cfg
