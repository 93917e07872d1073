"""repro_torch.runtime: restart supervision, straggler watchdog."""
