"""Synthetic data, client partitions and round batching of the port,
mirroring :mod:`repro.data`."""
