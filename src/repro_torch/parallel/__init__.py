"""Parallel context of the port (one device)."""
