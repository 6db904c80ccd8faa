"""Deterministic synthetic data (copy of ``repro.data``)."""
