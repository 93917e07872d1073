"""repro_torch.checkpoint: atomic, asynchronous checkpoints."""
