"""Full-state checkpoints in the JAX package's on-disk format."""
from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: F401
                                         load_checkpoint, save_checkpoint)
