"""repro_torch.train: the train step and the single-host driver."""
