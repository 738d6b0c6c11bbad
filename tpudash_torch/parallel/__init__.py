"""Inter-device probes over a list of devices driven from one process."""
