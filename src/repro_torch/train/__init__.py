"""repro_torch.train: the train step, the sharded step, the pipeline
schedule and the single-host driver."""
