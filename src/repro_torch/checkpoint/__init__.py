"""Full-state checkpoints in the JAX package's on-disk format."""
