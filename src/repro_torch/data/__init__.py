"""Synthetic data of the port (``repro/data``)."""
