"""Config schema and the paper's recsys configurations (copies of
``repro/configs/base.py`` and ``repro/configs/recsys_configs.py``)."""
from repro_torch.configs.base import (BlockCfg, InputShape, INPUT_SHAPES,
                                      ModelConfig)
from repro_torch.configs.recsys_configs import (AVAZU, CRITEO, KWAI, TAOBAO,
                                                criteo_syn)
