"""Ops of the serving path (counterpart of ``alink_tpu.ops``)."""
