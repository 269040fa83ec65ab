"""Micro-batched serving against the trainer's live state and the click
feedback that closes the serve -> train -> serve loop (port of
``repro/serving``; ``repro_torch.launch.online`` drives the loop)."""
from repro_torch.serving.feedback import ClickModel, FeedbackQueue
from repro_torch.serving.service import (ServingConfig, ServingService,
                                         StateCell)
from repro_torch.serving.traffic import TrafficGenerator, TrafficModel

__all__ = ["ClickModel", "FeedbackQueue", "ServingConfig", "ServingService",
           "StateCell", "TrafficGenerator", "TrafficModel"]
