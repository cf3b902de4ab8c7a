"""Parallel context, transport and overlap of the port."""
