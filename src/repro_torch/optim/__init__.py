"""repro_torch.optim: AdamW with fp32 masters, int8 gradient compression."""
