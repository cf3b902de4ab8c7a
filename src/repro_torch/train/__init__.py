"""The training loop of the port (``repro/train``)."""
