"""Utilities (counterpart of ``alink_tpu.utils``)."""
