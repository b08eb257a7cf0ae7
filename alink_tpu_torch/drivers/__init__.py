"""Drivers (counterpart of ``alink_tpu.drivers``): the A-LINK DFW driver.
The Multi-PIE, ArcFace and classical-AL drivers are not ported yet."""
