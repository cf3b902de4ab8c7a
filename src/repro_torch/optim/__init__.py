"""Optimizers of the port (``repro/optim``): Adam / AdamW."""
