"""The demo training workload: model, checkpoints and background runner."""
