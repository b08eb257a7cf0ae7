"""Measurement tools for the port, run as ``python -m alink_tpu_torch.tools.<name>``."""
