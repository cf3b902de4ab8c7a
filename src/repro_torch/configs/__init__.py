"""Dense-family model configs for the port (copies of ``repro.configs``)."""
