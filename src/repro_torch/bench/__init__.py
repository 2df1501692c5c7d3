"""The port's benchmark harness (``python -m repro_torch.bench.run``)."""
