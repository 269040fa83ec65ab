"""Dense-side optimizers of the NN worker (hand-written, not torch.optim)."""
