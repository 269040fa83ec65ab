"""Micro-batched serving against the trainer's live state (port of
``repro/serving``; the click-feedback loop comes with the training slice)."""
from repro_torch.serving.service import (ServingConfig, ServingService,
                                         StateCell)
from repro_torch.serving.traffic import TrafficGenerator, TrafficModel

__all__ = ["ServingConfig", "ServingService", "StateCell",
           "TrafficGenerator", "TrafficModel"]
