"""Encrypted-parameter protocol layer of the port (counterpart of
``rofl_tpu.fl``)."""
