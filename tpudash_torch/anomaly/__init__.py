"""Anomaly scoring on the GPUs: the counterpart of the device side of
``tpudash/anomaly/`` (the baselines and the engine are host numpy code that
the port's exporter never runs)."""
