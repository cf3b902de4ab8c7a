"""Dense transformer for the port: layers, prefill/decode, family `api`."""
